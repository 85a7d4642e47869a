"""Batched plonky2 PLONK verification in PyTorch.

Counterpart of `halo2_plonky2_verifier_tpu/plonk.py`: `PlonkProofShape`
(:35), `plonk_proof_shape` (:73), `PlonkProofBatch` (:97),
`load_plonk_proofs` (:148), `_canonicality` (:215), `fri_instance_polys`
(:229) and `build_plonk_verifier` (:243).  `build_plonk_verifier(common,
verifier_data)` returns `verify(batch) -> (B,) bool`; `common` and
`verifier_data` come from a circuit fixture (`circuit/common.py:
load_circuit`), the proofs from JSON (`proof_json.plonk_proof_from_json`,
`interop.plonk_proof_from_plonky2_json`).

A verification runs on the device of the batch: on a CUDA batch the
public-input hash runs through kernel K7 (`ops/poseidon.py:hash_no_pad`),
the transcript through one K2 launch (`transcript.run_schedule`), FRI's
leaves through K3 and its Merkle paths through K1 (`fri.verify_fri`); the
gate constraints, the vanishing terms and the quotient check are plain
PyTorch on the port's `stark.ExtOps`, as the JAX package runs them in jnp.
On a CPU batch every kernel's plain version runs.

Goldilocks caps only (the JAX PLONK path has no BN254 hasher).  A hash is a
(..., 4) int64 tensor; an extension value (..., 2).
"""

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from .fri import verify_fri
from .ops import goldilocks as gl
from .ops import goldilocks_ext as gle
from .ops import poseidon
from .circuit.vanishing import eval_vanishing_terms
from .stark import ExtOps, _ext_rows
from .transcript import TranscriptSchedule, extract, extract_ext, run_schedule
from .utils.profiling import scope
from .witness import check_field_shapes, fri_u64_fields, u64


@dataclass(frozen=True)
class PlonkProofShape:
    """Static PLONK proof geometry (fixed by the circuit's common data)."""
    num_wires: int
    num_routed_wires: int
    num_challenges: int
    num_constants: int          # selectors + gate constants + lookup sels
    num_partial_products: int
    quotient_degree_factor: int
    num_public_inputs: int
    cap_size: int
    lde_bits: int
    initial_depth: int
    reduction_arity_bits: tuple
    final_poly_len: int
    num_queries: int
    proof_of_work_bits: int
    degree_bits: int
    hasher: str = "poseidon_goldilocks"
    num_lookup_polys: int = 0   # logUp S polys (num_challenges * num_luts)

    @property
    def step_depths(self):
        depths = []
        bits = self.initial_depth
        for ab in self.reduction_arity_bits:
            bits -= ab
            depths.append(bits)
        return tuple(depths)

    @property
    def oracle_widths(self):
        return (self.num_constants + self.num_routed_wires,
                self.num_wires,
                self.num_challenges * (1 + self.num_partial_products)
                + self.num_lookup_polys,
                self.num_challenges * self.quotient_degree_factor)


def plonk_proof_shape(common) -> PlonkProofShape:
    cfg = common.config
    fri_params = common.fri_params()
    return PlonkProofShape(
        num_wires=cfg.num_wires,
        num_routed_wires=cfg.num_routed_wires,
        num_challenges=cfg.num_challenges,
        num_constants=common.num_constants,
        num_partial_products=common.num_partial_products,
        quotient_degree_factor=common.quotient_degree_factor,
        num_public_inputs=common.num_public_inputs,
        cap_size=1 << cfg.fri_config.cap_height,
        lde_bits=fri_params.lde_bits,
        initial_depth=fri_params.lde_bits - cfg.fri_config.cap_height,
        reduction_arity_bits=tuple(fri_params.reduction_arity_bits),
        final_poly_len=fri_params.final_poly_len,
        num_queries=cfg.fri_config.num_query_rounds,
        proof_of_work_bits=cfg.fri_config.proof_of_work_bits,
        degree_bits=common.degree_bits,
        num_lookup_polys=common.num_lookup_polys,
    )


@dataclass
class PlonkProofBatch:
    """Batched PLONK proofs, one int64 tensor per field (B = batch):

      constants_sigmas_cap (the circuit's, broadcast), wires_cap, zs_pp_cap,
      quotient_cap, commit_caps[i]: (B, cap, 4)
      constants, plonk_sigmas, wires, plonk_zs, plonk_zs_next,
      partial_products, quotient_polys, lookup_zs(_next): (B, n, 2)
      final_poly: (B, L, 2); pow_witness: (B,); public_inputs: (B, n_pi)
      initial_evals[o]: (B, Q, w_o); initial_siblings[o]: (B, Q, depth, 4)
      step_evals[i]: (B, Q, arity, 2); step_siblings[i]: (B, Q, depth_i, 4)
    lookup_zs and lookup_zs_next are None for a circuit without lookups.
    """
    shape: PlonkProofShape
    constants_sigmas_cap: torch.Tensor
    wires_cap: torch.Tensor
    zs_pp_cap: torch.Tensor
    quotient_cap: torch.Tensor
    constants: torch.Tensor
    plonk_sigmas: torch.Tensor
    wires: torch.Tensor
    plonk_zs: torch.Tensor
    plonk_zs_next: torch.Tensor
    partial_products: torch.Tensor
    quotient_polys: torch.Tensor
    lookup_zs: Optional[torch.Tensor]
    lookup_zs_next: Optional[torch.Tensor]
    commit_caps: list
    final_poly: torch.Tensor
    pow_witness: torch.Tensor
    initial_evals: list
    initial_siblings: list
    step_evals: list
    step_siblings: list
    public_inputs: torch.Tensor

    @property
    def batch_size(self):
        return self.pow_witness.shape[0]

    @property
    def device(self):
        return self.pow_witness.device

    def oracle_caps(self):
        return [self.constants_sigmas_cap, self.wires_cap, self.zs_pp_cap,
                self.quotient_cap]


# field order of the JAX PlonkProofBatch pytree (plonk.py:134-139 there)
PLONK_FIELDS = tuple(f.name for f in fields(PlonkProofBatch))[1:]
# the openings at zeta in fri-openings order (the lookup Zs follow them),
# then plonk_zs_next, the one opening at zeta*g besides the lookup Zs
_ZETA_OPENINGS = ("constants", "plonk_sigmas", "wires", "plonk_zs",
                  "partial_products", "quotient_polys")
_OPENINGS = _ZETA_OPENINGS + ("plonk_zs_next",)


def plonk_u64_fields(proofs, shape, verifier_data):
    """Proofs (`proof_json.PlonkProofWithPublicInputs`, one circuit) ->
    {field: uint64 array, list of arrays, or None}, the input of
    `plonk_batch_from_u64`."""
    S = shape

    def per_proof(get):
        return u64([get(p) for p in proofs])

    out = fri_u64_fields(proofs, S)
    out.update({
        "constants_sigmas_cap": np.broadcast_to(
            u64(verifier_data.constants_sigmas_cap),
            (len(proofs), S.cap_size, 4)).copy(),
        "wires_cap": per_proof(lambda p: p.proof.wires_cap),
        "zs_pp_cap": per_proof(
            lambda p: p.proof.plonk_zs_partial_products_cap),
        "quotient_cap": per_proof(lambda p: p.proof.quotient_polys_cap),
        "public_inputs": per_proof(lambda p: p.public_inputs),
    })
    for f in _OPENINGS:
        out[f] = per_proof(lambda p, f=f: getattr(p.proof.openings, f))
    for f in ("lookup_zs", "lookup_zs_next"):
        out[f] = (per_proof(lambda p, f=f: getattr(p.proof.openings, f))
                  if S.num_lookup_polys else None)
    return out


def plonk_field_shapes(S: PlonkProofShape):
    """field -> the shape of one proof's array (a list of shapes for a
    list field; None for an absent lookup field)."""
    cap, q = (S.cap_size, 4), S.num_queries
    lookups = (S.num_lookup_polys, 2) if S.num_lookup_polys else None
    return {
        "constants_sigmas_cap": cap, "wires_cap": cap, "zs_pp_cap": cap,
        "quotient_cap": cap,
        "constants": (S.num_constants, 2),
        "plonk_sigmas": (S.num_routed_wires, 2), "wires": (S.num_wires, 2),
        "plonk_zs": (S.num_challenges, 2),
        "plonk_zs_next": (S.num_challenges, 2),
        "partial_products": (S.num_challenges * S.num_partial_products, 2),
        "quotient_polys": (S.num_challenges * S.quotient_degree_factor, 2),
        "lookup_zs": lookups, "lookup_zs_next": lookups,
        "commit_caps": [cap] * len(S.reduction_arity_bits),
        "final_poly": (S.final_poly_len, 2), "pow_witness": (),
        "initial_evals": [(q, w) for w in S.oracle_widths],
        "initial_siblings": [(q, S.initial_depth, 4)] * 4,
        "step_evals": [(q, 1 << ab, 2) for ab in S.reduction_arity_bits],
        "step_siblings": [(q, d, 4) for d in S.step_depths],
        "public_inputs": (S.num_public_inputs,),
    }


def plonk_batch_from_u64(fields_u64, shape, device):
    """{field: uint64 arrays} (as from `plonk_u64_fields`) ->
    PlonkProofBatch on `device`.  Raises ValueError when an array's shape
    is not the one `shape` gives (a proof with a wrong count of openings,
    queries or siblings), or the batch sizes differ."""
    check_field_shapes(fields_u64, plonk_field_shapes(shape))

    def conv(v):
        if v is None:
            return None
        if isinstance(v, list):
            return [gl.from_u64(x, device) for x in v]
        return gl.from_u64(v, device)

    return PlonkProofBatch(shape=shape, **{f: conv(fields_u64[f])
                                           for f in PLONK_FIELDS})


def load_plonk_proofs(proofs, shape, verifier_data, device="cuda"):
    """Proofs of one circuit -> PlonkProofBatch on `device` (the card unless
    the caller asks for the CPU)."""
    return plonk_batch_from_u64(plonk_u64_fields(proofs, shape,
                                                 verifier_data),
                                shape, device)


def _tensors(batch):
    for f in PLONK_FIELDS:
        v = getattr(batch, f)
        if v is None:
            continue
        yield from (v if isinstance(v, list) else [v])


def canonicality_verdict(batch):
    """AND over every loaded value being < p, reduced to (B,) bool."""
    b = batch.batch_size
    verdict = torch.ones((b,), dtype=torch.bool, device=batch.device)
    for t in _tensors(batch):
        verdict = verdict & gl.is_canonical(t).reshape(b, -1).all(dim=-1)
    return verdict


def fri_instance_polys(S: PlonkProofShape):
    """4-oracle layout (plonky2 CommonCircuitData::get_fri_instance)."""
    cs = [(0, i) for i in range(S.num_constants + S.num_routed_wires)]
    wires = [(1, i) for i in range(S.num_wires)]
    zs = [(2, i) for i in range(S.num_challenges)]
    npp = S.num_challenges * S.num_partial_products
    pps = [(2, S.num_challenges + i) for i in range(npp)]
    lus = [(2, S.num_challenges + npp + i)
           for i in range(S.num_lookup_polys)]
    quot = [(3, i)
            for i in range(S.num_challenges * S.quotient_degree_factor)]
    return cs + wires + zs + pps + quot + lus, zs + lus


def plonk_challenge_stream(batch, verifier_data):
    """The transcript of a batch, in plonky2's get_challenges order: the
    public-input hash (B, 4), the schedule, the observed element stream (B,
    n_elements) and the ChallengeRefs of every challenge.  The openings are
    observed in fri-openings order: the zeta batch with the lookup Zs after
    the quotient, then the zeta*g batch."""
    S = batch.shape
    B = batch.batch_size
    # plonky2 get_public_inputs_hash is hash_no_pad (not hash_or_noop)
    with scope("public_inputs_hash"):
        pi_hash = poseidon.hash_no_pad(batch.public_inputs)
    sched = TranscriptSchedule()
    parts = []

    def observe(t):
        flat = t.reshape(B, -1)
        sched.observe(flat.shape[1])
        parts.append(flat)

    digest = torch.tensor([gl.signed(x) for x in verifier_data.circuit_digest],
                          dtype=torch.int64, device=batch.device)
    observe(digest.expand(B, 4))
    observe(pi_hash)
    observe(batch.wires_cap)
    refs = {"betas": sched.get_n_challenges(S.num_challenges),
            "gammas": sched.get_n_challenges(S.num_challenges),
            "deltas": (sched.get_n_challenges(2 * S.num_challenges)
                       if S.num_lookup_polys else [])}
    observe(batch.zs_pp_cap)
    refs["alphas"] = sched.get_n_challenges(S.num_challenges)
    observe(batch.quotient_cap)
    refs["zeta"] = sched.get_extension_challenge()

    for f in _ZETA_OPENINGS:
        observe(getattr(batch, f))
    if batch.lookup_zs is not None:
        observe(batch.lookup_zs)
    observe(batch.plonk_zs_next)
    if batch.lookup_zs_next is not None:
        observe(batch.lookup_zs_next)

    refs["fri_alpha"] = sched.get_extension_challenge()
    refs["fri_betas"] = []
    for c in batch.commit_caps:
        observe(c)
        refs["fri_betas"].append(sched.get_extension_challenge())
    observe(batch.final_poly)
    observe(batch.pow_witness[:, None])
    refs["fri_pow_response"] = sched.get_challenge()
    refs["queries"] = sched.get_n_challenges(S.num_queries)

    elements = torch.cat(parts, dim=1)
    assert elements.shape[1] == sched.n_elements
    return pi_hash, sched, elements, refs


def plonk_challenges(batch, verifier_data):
    """The public-input hash and every Fiat-Shamir challenge of a batch
    through one transcript run (K2): {pi_hash (B, 4), betas, gammas,
    deltas, alphas (lists of (B,)), zeta, fri_alpha (ext), fri_betas (list
    of ext), fri_pow_response (B,), queries (B, Q)}."""
    pi_hash, sched, elements, refs = plonk_challenge_stream(batch,
                                                            verifier_data)
    with scope("get_plonk_challenges"):
        ys = run_schedule(sched, elements)
    dev = batch.device
    q_steps = torch.tensor([r.step for r in refs["queries"]], device=dev)
    q_lanes = torch.tensor([r.lane for r in refs["queries"]], device=dev)
    out = {"pi_hash": pi_hash,
           "zeta": extract_ext(ys, refs["zeta"]),
           "fri_alpha": extract_ext(ys, refs["fri_alpha"]),
           "fri_betas": [extract_ext(ys, r) for r in refs["fri_betas"]],
           "fri_pow_response": extract(ys, refs["fri_pow_response"]),
           "queries": ys[q_steps, q_lanes].T}                   # (B, Q)
    for k in ("betas", "gammas", "deltas", "alphas"):
        out[k] = [extract(ys, r) for r in refs[k]]
    return out


def build_plonk_verifier(common, verifier_data):
    """Returns verify(batch: PlonkProofBatch) -> (B,) bool tensor.  A batch
    whose shape is not the circuit's raises ValueError."""
    shape = plonk_proof_shape(common)

    def verify(batch: PlonkProofBatch):
        S = batch.shape
        if S != shape:
            raise ValueError(f"batch shape {S} does not match {shape}")
        B = batch.batch_size
        dev = batch.device
        with scope("load_witness"):
            verdict = canonicality_verdict(batch)

        # 1. the public-input hash and every challenge (K7, K2)
        ch = plonk_challenges(batch, verifier_data)
        zeta = ch["zeta"]
        lookup_zs = ([] if batch.lookup_zs is None
                     else _ext_rows(batch.lookup_zs))
        lookup_zs_next = ([] if batch.lookup_zs_next is None
                          else _ext_rows(batch.lookup_zs_next))

        # 2. vanishing / quotient consistency at zeta
        with scope("vanishing_poly_check"):
            verdict = _vanishing_check(common, batch, ch, verdict,
                                       lookup_zs, lookup_zs_next)

        # 3. FRI over the 4-oracle instance (K3 leaves, K1 paths)
        zeta_polys, zeta_next_polys = fri_instance_polys(S)
        g_sub = gl.primitive_root_of_unity(S.degree_bits)
        zeta_next = gle.scalar_mul(zeta, gl.full((B,), g_sub, dev))
        openings_zeta = [r for f in _ZETA_OPENINGS
                         for r in _ext_rows(getattr(batch, f))] + lookup_zs
        openings_zeta_next = _ext_rows(batch.plonk_zs_next) + lookup_zs_next
        challenges = {
            "fri_alpha": ch["fri_alpha"],
            "fri_betas": ch["fri_betas"],
            "fri_pow_response": ch["fri_pow_response"],
            "query_lo": ch["queries"] & 0xFFFFFFFF,
            "instance_batches": [(zeta, zeta_polys),
                                 (zeta_next, zeta_next_polys)],
            "openings_batches": [openings_zeta, openings_zeta_next],
        }
        return verify_fri(S, batch, challenges, verdict)

    return verify


def _vanishing_check(common, batch, ch, verdict, lookup_zs, lookup_zs_next):
    """Z_H(zeta) * quotient(zeta) == the alpha-folded vanishing terms, per
    challenge, ANDed into `verdict`."""
    S = batch.shape
    B = batch.batch_size
    dev = batch.device
    zeta = ch["zeta"]
    F = ExtOps((B,), dev)
    one = F.one()
    n = 1 << S.degree_bits
    zeta_pow_n = gle.exp_power_of_2(zeta, S.degree_bits)
    z_h_zeta = gle.sub(zeta_pow_n, one)
    l0_den = gle.scalar_mul(gle.sub(zeta, one), gl.full((B,), n, dev))
    l0 = gle.mul(z_h_zeta, gle.inv(l0_den))
    pi_hash = ch["pi_hash"]
    pi_hash_ext = [gle.from_base(pi_hash[:, i]) for i in range(4)]
    terms = eval_vanishing_terms(
        F, common, zeta,
        _ext_rows(batch.constants), _ext_rows(batch.plonk_sigmas),
        _ext_rows(batch.wires),
        _ext_rows(batch.plonk_zs), _ext_rows(batch.plonk_zs_next),
        _ext_rows(batch.partial_products),
        pi_hash_ext, ch["betas"], ch["gammas"], l0,
        lookup_zs=lookup_zs, lookup_zs_next=lookup_zs_next,
        deltas=ch["deltas"])
    # sum_i alpha^i * term_i for every alpha at once (the alphas are
    # base-field values stacked on a leading axis)
    alphas = torch.stack(ch["alphas"])                          # (nc, B)
    acc = (torch.zeros_like(alphas), torch.zeros_like(alphas))
    for t in reversed(terms):
        acc = gle.add(gle.scalar_mul(acc, alphas), (t[0][None], t[1][None]))
    quot_rows = _ext_rows(batch.quotient_polys)
    q = S.quotient_degree_factor
    for i in range(S.num_challenges):
        recombined = gle.reduce_with_powers(quot_rows[i * q:(i + 1) * q],
                                            zeta_pow_n)
        verdict = verdict & gle.eq(gle.mul(z_h_zeta, recombined),
                                   (acc[0][i], acc[1][i]))
    return verdict

"""Proof batches: static proof geometry and batched int64 tensors.

`ProofShape` and `proof_shape` are copies of
`halo2_plonky2_verifier_tpu/witness.py:23-82`.  `ProofBatch` has the JAX
package's fields and shapes, with one int64 tensor per field where JAX holds
a (hi, lo) uint32 pair.

The port's state carried across from the JAX package is a proof batch:
`batch_from_numpy` takes the leaves of a JAX `ProofBatch` (numpy (hi, lo)
uint32 arrays in pytree order) and `load_batch_npz` reads the columnar
fixtures that `witness.save_batch_npz` wrote, with numpy alone, and
`save_batch_npz` writes them: the inverse of `u64_fields`.
`load_proofs` takes proofs read from JSON (`proof_json.py`, `interop.py`).

Hash-typed fields (caps and siblings) hold (..., 4) int64 words under both
hashers: four Goldilocks elements, or the four little-endian u64 words of
one BN254 Fr element.  The JAX package keeps a BN254 hash as ONE (..., 16)
uint32 leaf of 16-bit limbs; the loader packs it into words.
"""

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from .hashing import get_hash_ops, pack_hi_lo, split_hi_lo
from .ops import goldilocks as gl


@dataclass(frozen=True)
class ProofShape:
    """Static proof geometry (derived from config + stark + degree_bits)."""
    num_columns: int
    num_public_inputs: int
    num_zs: int                 # permutation Z polys (0 if unused)
    num_quotient: int
    cap_size: int
    lde_bits: int
    initial_depth: int          # lde_bits - cap_height
    reduction_arity_bits: tuple
    final_poly_len: int
    num_queries: int
    num_challenges: int
    num_challenge_sets: int     # permutation challenge sets drawn (batch size)
    proof_of_work_bits: int
    degree_bits: int
    hasher: str = "poseidon_goldilocks"

    @property
    def uses_permutation(self):
        return self.num_zs > 0

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
        w = [self.num_columns]
        if self.uses_permutation:
            w.append(self.num_zs)
        w.append(self.num_quotient)
        return tuple(w)


def proof_shape(stark, config, degree_bits,
                hasher="poseidon_goldilocks") -> ProofShape:
    fri_params = config.fri_params(degree_bits)
    uses_perm = stark.uses_permutation_args()
    return ProofShape(
        num_columns=stark.COLUMNS,
        num_public_inputs=stark.PUBLIC_INPUTS,
        num_zs=stark.num_permutation_batches(config) if uses_perm else 0,
        num_quotient=stark.quotient_degree_factor() * config.num_challenges,
        cap_size=1 << config.fri_config.cap_height,
        lde_bits=fri_params.lde_bits,
        initial_depth=fri_params.lde_bits - config.fri_config.cap_height,
        reduction_arity_bits=tuple(fri_params.reduction_arity_bits),
        final_poly_len=fri_params.final_poly_len,
        num_queries=config.fri_config.num_query_rounds,
        num_challenges=config.num_challenges,
        num_challenge_sets=stark.permutation_batch_size() if uses_perm else 0,
        proof_of_work_bits=config.fri_config.proof_of_work_bits,
        degree_bits=degree_bits,
        hasher=hasher,
    )


@dataclass
class ProofBatch:
    """Batched proof data, one int64 tensor per field (B = batch):

      trace_cap / zs_cap / quotient_cap: (B, cap, 4)
      local_values, next_values: (B, C, 2); permutation_zs(_next): (B, Z, 2)
      quotient_polys: (B, num_quotient, 2)
      commit_caps[i]: (B, cap, 4); final_poly: (B, L, 2); pow_witness: (B,)
      initial_evals[o]: (B, Q, w_o); initial_siblings[o]: (B, Q, depth, 4)
      step_evals[i]: (B, Q, arity, 2); step_siblings[i]: (B, Q, depth_i, 4)
      public_inputs: (B, n_pi)
    """
    shape: ProofShape
    trace_cap: torch.Tensor
    zs_cap: Optional[torch.Tensor]
    quotient_cap: torch.Tensor
    local_values: torch.Tensor
    next_values: torch.Tensor
    permutation_zs: Optional[torch.Tensor]
    permutation_zs_next: Optional[torch.Tensor]
    quotient_polys: torch.Tensor
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
        """Per-oracle expected caps, in oracle-index order."""
        caps = [self.trace_cap]
        if self.shape.uses_permutation:
            caps.append(self.zs_cap)
        caps.append(self.quotient_cap)
        return caps


# field order of the JAX ProofBatch pytree (halo2_plonky2_verifier_tpu/
# witness.py:304-307); the list-valued fields hold one entry per oracle or
# per FRI reduction step
_FIELDS = ("trace_cap", "zs_cap", "quotient_cap", "local_values", "next_values",
           "permutation_zs", "permutation_zs_next", "quotient_polys",
           "commit_caps", "final_poly", "pow_witness", "initial_evals",
           "initial_siblings", "step_evals", "step_siblings", "public_inputs")
_OPTIONAL = ("zs_cap", "permutation_zs", "permutation_zs_next")
# hash-typed fields: Merkle caps and siblings (`hash_arrays` in the JAX
# package's witness.py)
HASH_FIELDS = ("trace_cap", "zs_cap", "quotient_cap", "commit_caps",
               "initial_siblings", "step_siblings")
assert set(_FIELDS) == {f.name for f in fields(ProofBatch)} - {"shape"}
# the fields indexed by FRI query round on axis 1, which a query shard
# holds in part (the JAX package's parallel/mesh.py:71-74)
QUERY_FIELDS = ("initial_evals", "initial_siblings", "step_evals",
                "step_siblings")


def _leaf_counts(shape):
    """field -> number of arrays it holds (None: an absent optional field)."""
    n_steps = len(shape.reduction_arity_bits)
    n_oracles = len(shape.oracle_widths)
    lists = {"commit_caps": n_steps, "initial_evals": n_oracles,
             "initial_siblings": n_oracles, "step_evals": n_steps,
             "step_siblings": n_steps}
    out = {}
    for f in _FIELDS:
        if f in lists:
            out[f] = lists[f]
        elif f in _OPTIONAL and not shape.uses_permutation:
            out[f] = None
        else:
            out[f] = 1
    return out


def u64_fields(leaves, shape):
    """JAX ProofBatch leaves (numpy arrays in pytree order) -> {field: uint64
    array, list of arrays, or None}.  The pytree drops a None field and
    flattens a list field entry by entry; a Goldilocks array is a (hi, lo)
    pair of leaves, a hash array (caps and siblings) whatever the hasher's
    `jax_leaves` and `from_jax_leaves` say."""
    H = get_hash_ops(shape.hasher)
    leaves = list(leaves)
    pos = 0

    def take(n, pack):
        nonlocal pos
        if pos + n > len(leaves):
            raise ValueError("too few leaves for this proof shape")
        arrays = [np.asarray(x) for x in leaves[pos:pos + n]]
        pos += n
        return pack(*arrays)

    out = {}
    for f, count in _leaf_counts(shape).items():
        n, pack = ((H.jax_leaves, H.from_jax_leaves) if f in HASH_FIELDS
                   else (2, pack_hi_lo))
        if count is None:
            out[f] = None
        elif f in ("commit_caps", "initial_evals", "initial_siblings",
                   "step_evals", "step_siblings"):
            out[f] = [take(n, pack) for _ in range(count)]
        else:
            out[f] = take(n, pack)
    if pos != len(leaves):
        raise ValueError(f"{len(leaves) - pos} leaves left over for this "
                         "proof shape")
    return out


def field_shapes(S: ProofShape):
    """field -> the shape of one proof's array (a list of shapes for a
    list field; None for an absent permutation field)."""
    cap, q = (S.cap_size, 4), S.num_queries
    zs = (S.num_zs, 2) if S.uses_permutation else None
    return {
        "trace_cap": cap, "zs_cap": cap if S.uses_permutation else None,
        "quotient_cap": cap,
        "local_values": (S.num_columns, 2), "next_values": (S.num_columns, 2),
        "permutation_zs": zs, "permutation_zs_next": zs,
        "quotient_polys": (S.num_quotient, 2),
        "commit_caps": [cap] * len(S.reduction_arity_bits),
        "final_poly": (S.final_poly_len, 2), "pow_witness": (),
        "initial_evals": [(q, w) for w in S.oracle_widths],
        "initial_siblings": [(q, S.initial_depth, 4)] * len(S.oracle_widths),
        "step_evals": [(q, 1 << ab, 2) for ab in S.reduction_arity_bits],
        "step_siblings": [(q, d, 4) for d in S.step_depths],
        "public_inputs": (S.num_public_inputs,),
    }


def check_field_shapes(fields_u64, want_shapes):
    """Raises ValueError when an array's shape is not the one
    `want_shapes` (as from `field_shapes`) gives it, at the batch size of
    `pow_witness`: a proof with a wrong count of openings, queries or
    siblings, or batch sizes that differ."""
    b = len(fields_u64["pow_witness"])
    for f, want in want_shapes.items():
        v = fields_u64[f]
        got = ([x.shape for x in v] if isinstance(v, list)
               else None if v is None else v.shape)
        want = ([(b,) + w for w in want] if isinstance(want, list)
                else None if want is None else (b,) + want)
        if got != want:
            raise ValueError(f"{f}: shape {got}, expected {want}")


def batch_from_u64(fields_u64, shape, device):
    """{field: uint64 arrays} (as from `u64_fields`) -> ProofBatch.  Raises
    ValueError when an array's shape is not the one `shape` gives."""
    check_field_shapes(fields_u64, field_shapes(shape))

    def conv(v):
        if v is None:
            return None
        if isinstance(v, list):
            return [gl.from_u64(x, device) for x in v]
        return gl.from_u64(v, device)

    return ProofBatch(shape=shape, **{f: conv(fields_u64[f]) for f in _FIELDS})


def u64(nested):
    """Nested host ints below 2^64 -> a uint64 array (a larger value
    raises OverflowError)."""
    return np.array(nested, dtype=np.uint64)


def bn254_words(nested):
    """Nested host ints below 2^256 -> (..., 4) uint64 little-endian
    words."""
    a = np.array(nested, dtype=object)
    if a.size and not ((a >= 0) & (a < 1 << 256)).all():
        raise ValueError("a BN254 hash out of [0, 2^256)")
    return np.stack([((a >> (64 * k)) & ((1 << 64) - 1)).astype(np.uint64)
                     for k in range(4)], axis=-1)


def fri_u64_fields(proofs, shape, hashes=u64):
    """The FRI opening proofs' fields of `proofs` (any proof type with
    `proof.opening_proof`) -> {commit_caps, final_poly, pow_witness,
    initial_evals, initial_siblings, step_evals, step_siblings} as uint64
    arrays; `hashes` converts the hash-typed ones."""
    S = shape
    B = len(proofs)
    fris = [p.proof.opening_proof for p in proofs]
    qrs = [f.query_round_proofs for f in fris]
    out = {
        "commit_caps": [hashes([f.commit_phase_merkle_caps[i] for f in fris])
                        for i in range(len(S.reduction_arity_bits))],
        "final_poly": u64([f.final_poly for f in fris]),
        "pow_witness": u64([f.pow_witness for f in fris]),
        "initial_evals": [], "initial_siblings": [],
        "step_evals": [], "step_siblings": [],
    }
    for oi in range(len(S.oracle_widths)):
        out["initial_evals"].append(u64([
            [qr.initial_trees_proof.evals_proofs[oi][0] for qr in q]
            for q in qrs]))
        out["initial_siblings"].append(hashes([
            [qr.initial_trees_proof.evals_proofs[oi][1].siblings for qr in q]
            for q in qrs]).reshape(B, S.num_queries, S.initial_depth, 4))
    for si in range(len(S.reduction_arity_bits)):
        out["step_evals"].append(u64([[qr.steps[si].evals for qr in q]
                                      for q in qrs]))
        out["step_siblings"].append(hashes([
            [qr.steps[si].merkle_proof.siblings for qr in q]
            for q in qrs]).reshape(B, S.num_queries, S.step_depths[si], 4))
    return out


def proof_u64_fields(proofs, shape):
    """Proofs (`proof_json.StarkProofWithPublicInputs`, one geometry) ->
    {field: uint64 arrays}, the input of `batch_from_u64` (the JAX
    package's `load_proofs`, `witness.py:134` there).  A hash array holds
    (..., 4) words under both hashers."""
    S = shape
    hashes = bn254_words if S.hasher == "poseidon_bn254" else u64

    def per_proof(get, conv=u64):
        return conv([get(p) for p in proofs])

    out = fri_u64_fields(proofs, S, hashes)
    out.update({
        "trace_cap": per_proof(lambda p: p.proof.trace_cap, hashes),
        "zs_cap": (per_proof(lambda p: p.proof.permutation_zs_cap, hashes)
                   if S.uses_permutation else None),
        "quotient_cap": per_proof(lambda p: p.proof.quotient_polys_cap,
                                  hashes),
        "public_inputs": per_proof(lambda p: p.public_inputs),
    })
    for f in ("local_values", "next_values", "quotient_polys"):
        out[f] = per_proof(lambda p, f=f: getattr(p.proof.openings, f))
    for f in ("permutation_zs", "permutation_zs_next"):
        out[f] = (per_proof(lambda p, f=f: getattr(p.proof.openings, f))
                  if S.uses_permutation else None)
    return out


def load_proofs(proofs, shape, device="cuda"):
    """Proofs (`proof_json.StarkProofWithPublicInputs`, as read by
    `proof_json.proof_from_json` or `interop.stark_proof_from_plonky2_json`)
    -> ProofBatch on `device` (the card unless the caller asks for the
    CPU)."""
    return batch_from_u64(proof_u64_fields(proofs, shape), shape, device)


def batch_from_numpy(leaves, shape, device):
    """JAX ProofBatch leaves (numpy (hi, lo) uint32 pairs) -> ProofBatch,
    each pair packed as (hi << 32) | lo into int64."""
    return batch_from_u64(u64_fields(leaves, shape), shape, device)


def npz_leaves(path):
    """The leaves a0, a1, ... of a columnar npz fixture, in order."""
    with np.load(path) as data:
        n = len(data.files)
        names = [f"a{i}" for i in range(n)]
        if sorted(names) != sorted(data.files):
            raise ValueError(f"{path}: unexpected array names")
        return [data[k] for k in names]


def load_batch_npz(path, shape, device):
    """Read a columnar fixture (`fib_stark_n*_x*.npz`) with numpy alone."""
    return batch_from_numpy(npz_leaves(path), shape, device)


def jax_leaves(batch):
    """A ProofBatch (on any device) -> the leaves of the JAX package's
    ProofBatch pytree, numpy uint32, in order: a Goldilocks array as its
    (hi, lo) pair, a hash array as the hasher's `to_jax_leaves` gives it,
    an absent field none (the inverse of `u64_fields`)."""
    H = get_hash_ops(batch.shape.hasher)
    out = []
    for f in _FIELDS:
        v = getattr(batch, f)
        if v is None:
            continue
        split = H.to_jax_leaves if f in HASH_FIELDS else split_hi_lo
        for t in (v if isinstance(v, list) else [v]):
            out.extend(split(gl.to_u64(t)))
    return out


def save_batch_npz(path, batch):
    """Write `batch` as a columnar npz fixture: leaves a0, a1, ... of the
    JAX ProofBatch, as the JAX package's `save_batch_npz`
    (`witness.py:229` there) writes them, so `load_batch_npz` and the JAX
    loader read it back."""
    np.savez_compressed(path, **{f"a{i}": x for i, x in
                                 enumerate(jax_leaves(batch))})


def _tensors(batch, fields_=_FIELDS):
    for f in fields_:
        v = getattr(batch, f)
        if v is None:
            continue
        if isinstance(v, list):
            yield from v
        else:
            yield v


def canonicality_verdict(batch: ProofBatch):
    """AND over all loaded values being canonical, reduced to (B,) bool: the
    executor form of the witness range checks.  Goldilocks values are
    checked against the Goldilocks modulus, hash arrays against the
    hasher's (`canonical_ok`: the BN254 modulus for a BN254 hash)."""
    H = get_hash_ops(batch.shape.hasher)
    b = batch.batch_size
    verdict = torch.ones((b,), dtype=torch.bool, device=batch.device)
    scalars = tuple(f for f in _FIELDS if f not in HASH_FIELDS)
    for t in _tensors(batch, scalars):
        verdict = verdict & gl.is_canonical(t).reshape(b, -1).all(dim=-1)
    for t in _tensors(batch, HASH_FIELDS):
        verdict = verdict & H.canonical_ok(t).reshape(b, -1).all(dim=-1)
    return verdict

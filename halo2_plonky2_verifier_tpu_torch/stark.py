"""Top-level batched STARK verification in PyTorch.

`build_verifier(stark, config, degree_bits, check_vanishing, hasher,
query_shard, transcript)` returns `verify(batch) -> (B,) bool`: the
challenge derivation through one transcript run, the vanishing-polynomial /
quotient consistency check at zeta, and FRI with every Merkle path.
Counterpart of `halo2_plonky2_verifier_tpu/stark.py:build_verifier`, for
both of its hashers and both of its transcripts:

  hasher "poseidon_goldilocks": Merkle leaves through K3, paths through K1;
  hasher "poseidon_bn254":      leaves through K5, paths through K4;
  transcript "poseidon_goldilocks": one K2 launch for the whole sponge;
  transcript "poseidon_bn254":      one K6 launch per sponge step.

A verification runs on the device of the batch it is given: on a CUDA batch
every kernel of the path launches; on a CPU batch their plain versions run.

With a `QueryShard` the verifier checks one of `count` equal slices of the
FRI query rounds (`parallel/mesh.py`): every rank runs the transcript and
the vanishing check, verifies its own queries, and the verdict is AND-reduced
over the shard's process group.
"""

from itertools import product as iter_product
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from .fri import verify_fri
from .hashing import get_hash_ops
from .ops import goldilocks as gl
from .ops import goldilocks_ext as gle
from .transcript import (BN254TranscriptSchedule, TranscriptSchedule, extract,
                         extract_ext, run_schedule, run_schedule_bn254)
from .utils.logging import get_logger
from .utils.profiling import scope
from .witness import (QUERY_FIELDS, ProofBatch, canonicality_verdict,
                      proof_shape)


class QueryShard(NamedTuple):
    """This rank's place among the query shards: shard `index` of `count`,
    the AND of the verdicts taken over `group` (a torch.distributed process
    group of `count` ranks)."""
    index: int
    count: int
    group: Any


class CollectingConsumer:
    """ConstraintConsumer-compatible collector: records the weighted
    constraint values in emission order, and `fold` runs the alpha fold for
    all alphas at once."""

    def __init__(self, F, z_last, lagrange_first, lagrange_last):
        self.F = F
        self.z_last = z_last
        self.lagrange_first = lagrange_first
        self.lagrange_last = lagrange_last
        self.entries = []

    def constraint(self, c):
        self.entries.append(c)

    def constraint_transition(self, c):
        self.entries.append(self.F.mul(c, self.z_last))

    def constraint_first_row(self, c):
        self.entries.append(self.F.mul(c, self.lagrange_first))

    def constraint_last_row(self, c):
        self.entries.append(self.F.mul(c, self.lagrange_last))

    def fold(self, alphas_ext):
        """acc_j = acc_j * alpha_j + c over the entries, the alphas stacked
        on a leading axis."""
        al = (torch.stack([a[0] for a in alphas_ext]),
              torch.stack([a[1] for a in alphas_ext]))
        acc = gle.zeros_like(al)
        for c in self.entries:
            acc = gle.add(gle.mul(acc, al), (c[0][None], c[1][None]))
        return [(acc[0][j], acc[1][j]) for j in range(len(alphas_ext))]


class ExtOps:
    """Field-ops adapter over extension elements of batch shape
    `batch_shape`, for Stark.eval, the permutation checks and the PLONK
    gates and vanishing terms (the interface of the JAX package's
    ExtOpsJax, with `mul_const_small`, `mul_many` and `fold`, which the
    PLONK gates call)."""

    def __init__(self, batch_shape, device):
        self.batch_shape = tuple(batch_shape)
        self.device = device

    def zero(self):
        return (gl.zeros(self.batch_shape, self.device),
                gl.zeros(self.batch_shape, self.device))

    def one(self):
        return (gl.full(self.batch_shape, 1, self.device),
                gl.zeros(self.batch_shape, self.device))

    def add(self, a, b):
        return gle.add(a, b)

    def sub(self, a, b):
        return gle.sub(a, b)

    def mul(self, a, b):
        return gle.mul(a, b)

    def from_base(self, x):
        """A host int, a host (int, int) pair, or a base-field tensor."""
        if isinstance(x, tuple) and isinstance(x[0], int):
            return (gl.full(self.batch_shape, x[0], self.device),
                    gl.full(self.batch_shape, x[1], self.device))
        if isinstance(x, int):
            return (gl.full(self.batch_shape, x, self.device),
                    gl.zeros(self.batch_shape, self.device))
        return gle.from_base(x)

    def mul_const_small(self, c, a):
        """a * c for a small host int 0 <= c < 2^16 (the PLONK gates' MDS
        entries): two `gl.mul_const_small` where `mul` takes four base
        products."""
        return (gl.mul_const_small(a[0], c), gl.mul_const_small(a[1], c))

    def mul_elems(self, xs, ys):
        """[x * y for x, y in zip(xs, ys)] as one stacked multiply."""
        if not xs:
            return []
        out = gle.mul((torch.stack([x[0] for x in xs]),
                       torch.stack([x[1] for x in xs])),
                      (torch.stack([y[0] for y in ys]),
                       torch.stack([y[1] for y in ys])))
        return [(out[0][i], out[1][i]) for i in range(len(xs))]

    def mul_many(self, a, xs):
        """[a * x for x in xs] as one stacked multiply."""
        return self.mul_elems([a] * len(xs), xs)

    def fold(self, body, carry, xs):
        """body(carry, x) -> (carry, y) over xs; returns (carry, [y...])."""
        ys = []
        for x in xs:
            carry, y = body(carry, x)
            ys.append(y)
        return carry, ys


# ----------------------------------------------------------------------------
# Permutation argument (starky::permutation), copies of
# halo2_plonky2_verifier_tpu/refimpl/prover.py:81-91,204-224
# ----------------------------------------------------------------------------

def get_permutation_batches(permutation_pairs, challenge_sets, num_challenges,
                            batch_size):
    """instances = pairs x challenge indices, chunked; instance i within a
    batch uses challenge_sets[i][chal]."""
    instances = list(iter_product(permutation_pairs, range(num_challenges)))
    batches = []
    for start in range(0, len(instances), batch_size):
        chunk = instances[start:start + batch_size]
        batches.append([
            (pair, challenge_sets[i][chal])
            for i, (pair, chal) in enumerate(chunk)
        ])
    return batches


def eval_permutation_checks(F, local_values, local_zs, next_zs, batches,
                            consumer):
    """Z(first) = 1 per Z poly, then per batch
    Z(gx) * prod(reduced_rhs) - Z(x) * prod(reduced_lhs) on all rows."""
    one = F.one()
    for z in local_zs:
        consumer.constraint_first_row(F.sub(z, one))
    for i, instances in enumerate(batches):
        red_l_prod = one
        red_r_prod = one
        for (pair, (beta, gamma)) in instances:
            red_l = F.from_base(gamma)
            red_r = red_l
            w = one
            for (lhs, rhs) in pair.column_pairs:
                red_l = F.add(red_l, F.mul(w, local_values[lhs]))
                red_r = F.add(red_r, F.mul(w, local_values[rhs]))
                w = F.mul(w, F.from_base(beta))
            red_l_prod = F.mul(red_l_prod, red_l)
            red_r_prod = F.mul(red_r_prod, red_r)
        consumer.constraint(
            F.sub(F.mul(next_zs[i], red_r_prod), F.mul(local_zs[i], red_l_prod)))


def _ext_rows(t):
    """(B, n, 2) -> list of n ext (B,) values."""
    return [(t[:, i, 0], t[:, i, 1]) for i in range(t.shape[1])]


def fri_instance_polys(shape):
    """Oracle/polynomial layout: (zeta_polys, zeta_next_polys) as
    (oracle_index, poly_index) lists."""
    trace = [(0, i) for i in range(shape.num_columns)]
    zs, quot_oracle = [], 1
    if shape.uses_permutation:
        zs = [(1, i) for i in range(shape.num_zs)]
        quot_oracle = 2
    quot = [(quot_oracle, i) for i in range(shape.num_quotient)]
    return trace + zs + quot, trace + zs


TRANSCRIPTS = {"poseidon_goldilocks": (TranscriptSchedule, run_schedule),
               "poseidon_bn254": (BN254TranscriptSchedule, run_schedule_bn254)}


def challenge_stream(batch, transcript="poseidon_goldilocks"):
    """The transcript of a batch: its schedule, the observed element stream
    (B, n_elements) in observation order, and the ChallengeRefs of every
    challenge (order of challenger/mod.rs:168-222).  A cap is observed hash
    by hash through the hasher's `to_gl_elements` (challenger/mod.rs:65-74):
    a Goldilocks hash as its 4 elements, a BN254 hash as its 5 56-bit
    limbs."""
    S = batch.shape
    B = batch.batch_size
    H = get_hash_ops(S.hasher)
    sched = TRANSCRIPTS[transcript][0]()
    parts = []

    def observe(t):
        flat = t.reshape(B, -1)
        sched.observe(flat.shape[1])
        parts.append(flat)

    def observe_cap(cap):
        observe(H.to_gl_elements(cap))

    observe_cap(batch.trace_cap)
    perm_refs = None
    if S.uses_permutation:
        perm_refs = [
            [(sched.get_challenge(), sched.get_challenge())
             for _ in range(S.num_challenges)]
            for _ in range(S.num_challenge_sets)
        ]
        observe_cap(batch.zs_cap)
    alpha_refs = sched.get_n_challenges(S.num_challenges)
    observe_cap(batch.quotient_cap)
    zeta_ref = sched.get_extension_challenge()

    # openings in to_fri_openings order
    observe(batch.local_values)
    if S.uses_permutation:
        observe(batch.permutation_zs)
    observe(batch.quotient_polys)
    observe(batch.next_values)
    if S.uses_permutation:
        observe(batch.permutation_zs_next)

    fri_alpha_ref = sched.get_extension_challenge()
    beta_refs = []
    for cap in batch.commit_caps:
        observe_cap(cap)
        beta_refs.append(sched.get_extension_challenge())
    observe(batch.final_poly)
    observe(batch.pow_witness[:, None])
    pow_ref = sched.get_challenge()
    query_refs = sched.get_n_challenges(S.num_queries)

    elements = torch.cat(parts, dim=1)
    assert elements.shape[1] == sched.n_elements
    refs = {"perm": perm_refs, "alphas": alpha_refs, "zeta": zeta_ref,
            "fri_alpha": fri_alpha_ref, "betas": beta_refs, "pow": pow_ref,
            "queries": query_refs}
    return sched, elements, refs


def and_over_group(verdict, group):
    """The AND of a (B,) bool verdict over the ranks of `group`: all_reduce
    (MIN) of an int32 copy, the counterpart of JAX's `pmin`.  Under gloo the
    copy crosses on the host; under NCCL on the card."""
    v = verdict.to(torch.int32)
    if dist.get_backend(group) != "nccl":
        v = v.cpu()
    dist.all_reduce(v, op=dist.ReduceOp.MIN, group=group)
    return v.to(verdict.device) == 1


def _stark_challenges(batch, transcript, run, query_shard, q_local):
    """Every challenge of a batch through one transcript run: zeta,
    alphas, fri_alpha, fri_betas, pow_response, query_lo (B, Q; this
    shard's slice under a query shard) and perm_challenges."""
    S = batch.shape
    dev = batch.device
    sched, elements, refs = challenge_stream(batch, transcript)
    ys = run(sched, elements)
    q_steps = torch.tensor([r.step for r in refs["queries"]], device=dev)
    q_lanes = torch.tensor([r.lane for r in refs["queries"]], device=dev)
    query_lo = ys[q_steps, q_lanes].T & 0xFFFFFFFF              # (B, Q)
    if query_shard is not None:
        start = query_shard.index * q_local
        query_lo = query_lo[:, start:start + q_local]
    perm_challenges = None
    if S.uses_permutation:
        perm_challenges = [
            [(extract(ys, b), extract(ys, g)) for (b, g) in cset]
            for cset in refs["perm"]
        ]
    return {"zeta": extract_ext(ys, refs["zeta"]),
            "alphas": [extract(ys, r) for r in refs["alphas"]],
            "fri_alpha": extract_ext(ys, refs["fri_alpha"]),
            "fri_betas": [extract_ext(ys, r) for r in refs["betas"]],
            "pow_response": extract(ys, refs["pow"]),
            "query_lo": query_lo,
            "perm_challenges": perm_challenges}


def _vanishing_check(stark, batch, ch, verdict, check_vanishing):
    """The quotient's consistency with the constraints at zeta:
    Z_H(zeta) * quotient(zeta) == the alpha-folded constraints, per
    challenge, ANDed into `verdict` unless `check_vanishing` is False (the
    terms are computed either way)."""
    S = batch.shape
    B = batch.batch_size
    dev = batch.device
    zeta = ch["zeta"]
    g_sub = gl.primitive_root_of_unity(S.degree_bits)
    n = 1 << S.degree_bits
    F = ExtOps((B,), dev)
    one = F.one()
    zeta_pow_n = gle.exp_power_of_2(zeta, S.degree_bits)
    z_h_zeta = gle.sub(zeta_pow_n, one)
    l0_den = gle.scalar_mul(gle.sub(zeta, one), gl.full((B,), n, dev))
    llast_den = gle.scalar_mul(
        gle.sub(gle.scalar_mul(zeta, gl.full((B,), g_sub, dev)), one),
        gl.full((B,), n, dev))
    l0_den_inv, llast_den_inv = gle.inv_pair(l0_den, llast_den)
    l0 = gle.mul(z_h_zeta, l0_den_inv)
    llast = gle.mul(z_h_zeta, llast_den_inv)
    z_last = gle.sub(zeta, F.from_base(pow(g_sub, n - 1, gl.P)))

    alphas_ext = [gle.from_base(a) for a in ch["alphas"]]
    consumer = CollectingConsumer(F, z_last, l0, llast)
    local = _ext_rows(batch.local_values)
    nxt = _ext_rows(batch.next_values)
    pis = [gle.from_base(batch.public_inputs[:, i])
           for i in range(S.num_public_inputs)]
    stark.eval(F, local, nxt, pis, consumer)
    if S.uses_permutation:
        batches = get_permutation_batches(
            stark.permutation_pairs(), ch["perm_challenges"],
            S.num_challenges, stark.permutation_batch_size())
        eval_permutation_checks(
            F, local, _ext_rows(batch.permutation_zs),
            _ext_rows(batch.permutation_zs_next), batches, consumer)

    accumulators = consumer.fold(alphas_ext)
    quot_rows = _ext_rows(batch.quotient_polys)
    factor = len(quot_rows) // S.num_challenges
    for i, acc in enumerate(accumulators):
        chunk = quot_rows[i * factor:(i + 1) * factor]
        recombined = gle.reduce_with_powers(chunk, zeta_pow_n)
        if check_vanishing:
            verdict = verdict & gle.eq(gle.mul(z_h_zeta, recombined), acc)
    return verdict


def build_verifier(stark, config, degree_bits, check_vanishing=True,
                   hasher="poseidon_goldilocks", query_shard=None,
                   transcript="poseidon_goldilocks"):
    """Returns verify(batch: ProofBatch) -> (B,) bool tensor.  `hasher`
    selects the Merkle commitment hash and `transcript` the Fiat-Shamir
    sponge, each "poseidon_goldilocks" or "poseidon_bn254"; any other name
    raises ValueError.  `check_vanishing=False` leaves the quotient check at
    zeta out of the verdict.

    `query_shard` (a `QueryShard`): `verify` takes a batch whose
    query-indexed fields (`witness.QUERY_FIELDS`) hold this shard's
    Q / count queries, starting at index * Q / count (as
    `parallel.mesh.shard_batch` slices them), and AND-reduces the verdict
    over the shard's group.  `count` must divide the number of queries."""
    get_hash_ops(hasher)
    if transcript not in TRANSCRIPTS:
        raise ValueError(f"unknown transcript {transcript!r}")
    run = TRANSCRIPTS[transcript][1]
    shape = proof_shape(stark, config, degree_bits, hasher)
    q_local = shape.num_queries
    if query_shard is not None:
        if (query_shard.count < 1 or shape.num_queries % query_shard.count
                or not 0 <= query_shard.index < query_shard.count):
            raise ValueError(
                f"query shard {query_shard.index} of {query_shard.count}: "
                f"the count must divide {shape.num_queries} queries")
        q_local = shape.num_queries // query_shard.count
    get_logger(__name__).info(
        "build_verifier: %s n=2^%d queries=%d arities=%s hasher=%s "
        "transcript=%s vanishing=%s qshard=%s", type(stark).__name__,
        degree_bits, shape.num_queries, list(shape.reduction_arity_bits),
        hasher, transcript, check_vanishing,
        None if query_shard is None else query_shard[:2])

    def verify(batch: ProofBatch):
        S = batch.shape
        if S != shape:
            raise ValueError(f"batch shape {S} does not match {shape}")
        B = batch.batch_size
        dev = batch.device
        if query_shard is not None:
            for f in QUERY_FIELDS:
                for t in getattr(batch, f):
                    if t.shape[1] != q_local:
                        raise ValueError(
                            f"{f}: {t.shape[1]} queries, expected this "
                            f"shard's {q_local}")
        with scope("load_witness"):
            verdict = canonicality_verdict(batch)

        # 1. transcript: one sponge run over the observed element stream
        with scope("get_stark_challenges"):
            ch = _stark_challenges(batch, transcript, run, query_shard,
                                   q_local)

        # 2. vanishing polynomial / quotient consistency at zeta
        with scope("vanishing_poly_check"):
            verdict = _vanishing_check(stark, batch, ch, verdict,
                                       check_vanishing)

        # 3. FRI
        zeta = ch["zeta"]
        g_sub = gl.primitive_root_of_unity(S.degree_bits)
        zeta_next = gle.scalar_mul(zeta, gl.full((B,), g_sub, dev))
        zeta_polys, zeta_next_polys = fri_instance_polys(S)
        openings_zeta = (_ext_rows(batch.local_values)
                         + (_ext_rows(batch.permutation_zs)
                            if S.uses_permutation else [])
                         + _ext_rows(batch.quotient_polys))
        openings_zeta_next = (_ext_rows(batch.next_values)
                              + (_ext_rows(batch.permutation_zs_next)
                                 if S.uses_permutation else []))
        challenges = {
            "fri_alpha": ch["fri_alpha"],
            "fri_betas": ch["fri_betas"],
            "fri_pow_response": ch["pow_response"],
            "query_lo": ch["query_lo"],
            "instance_batches": [(zeta, zeta_polys),
                                 (zeta_next, zeta_next_polys)],
            "openings_batches": [openings_zeta, openings_zeta_next],
        }
        verdict = verify_fri(shape, batch, challenges, verdict)
        if query_shard is not None:
            verdict = and_over_group(verdict, query_shard.group)
        return verdict

    return verify

"""FRI verification over all query rounds of all proofs at once.

Counterpart of `halo2_plonky2_verifier_tpu/fri.py`.  The 84 query rounds
are a tensor axis Q beside the proof axis B; every Merkle path check of the
verification (each oracle's initial proof and each reduction step's proof)
is stacked on one lane axis and runs through the hasher's two Merkle kernels
(`hashing.py`): under Poseidon-Goldilocks the step leaves are sponged by
kernel K3 and the paths run through kernel K1 (`ops/merkle_kernels.py`);
under Poseidon-BN254 the leaves are hashed by kernel K5 and the paths run
through kernel K4 (`ops/bn254_kernels.py`).  `assert_equal` becomes boolean
lanes AND-reduced into a per-proof verdict.

Index conventions follow the reference chip: x_index = the low lde_bits of
the query challenge (LSB-first bits drive left/right selection), cap index =
its top cap_height bits, subgroup point = 7 * phi^bitrev(x_index).
"""

import torch

from .hashing import get_hash_ops
from .ops import goldilocks as gl
from .ops import goldilocks_ext as gle
from .utils.profiling import count, scope


def _pow_root_consts(n_log):
    """Host table: phi^(2^k) for phi = primitive 2^n_log-th root."""
    phi = gl.primitive_root_of_unity(n_log)
    out = []
    cur = phi
    for _ in range(n_log):
        out.append(cur)
        cur = cur * cur % gl.P
    return out


def exp_from_bits_const_base(idx, base_pows, nbits):
    """prod_i (bit_i(idx) ? base^(2^i) : 1) with base_pows[i] = base^(2^i)."""
    acc = gl.full(idx.shape, 1, idx.device)
    for i in range(nbits):
        bit = ((idx >> i) & 1) == 1
        acc = gl.select(bit, gl.mul(acc, gl.full((), base_pows[i], idx.device)),
                        acc)
    return acc


def bit_reverse_u32(idx, nbits):
    """Bit-reverse the low nbits of a non-negative int64 index tensor."""
    out = torch.zeros_like(idx)
    for i in range(nbits):
        out = out | (((idx >> i) & 1) << (nbits - 1 - i))
    return out


def _stack_paths(leaf_datas, idxs, sibs, depths, d_max, leaf_hash):
    """Lanes = flattened (slot, batch, query).  Hashes each slot's leaves
    (slots of one width share one `leaf_hash` launch) and stacks the
    inputs of the path kernel: node (4, S*M), idx (S*M,), sib (d_max, 4,
    S*M) zero-padded, active (d_max, S*M) int32."""
    b, q = idxs[0].shape
    m = b * q
    s = len(depths)
    dev = idxs[0].device
    planes = [ld.reshape(m, ld.shape[-1]).T for ld in leaf_datas]   # (w, M)
    nodes = [None] * s
    for w in sorted({p.shape[0] for p in planes}):
        ids = [i for i, p in enumerate(planes) if p.shape[0] == w]
        h = leaf_hash(torch.cat([planes[i] for i in ids], dim=1).contiguous())
        for j, i in enumerate(ids):
            nodes[i] = h[:, j * m:(j + 1) * m]
    node = torch.cat(nodes, dim=1).contiguous()                     # (4, S*M)
    idx_flat = torch.cat([i.reshape(m) for i in idxs])              # (S*M,)
    sib_parts = []
    for sb, d in zip(sibs, depths):
        sp = sb.permute(2, 3, 0, 1).reshape(d, 4, m)
        if d < d_max:
            sp = torch.cat([sp, sp.new_zeros((d_max - d, 4, m))])
        sib_parts.append(sp)
    sib = torch.cat(sib_parts, dim=2).contiguous()                  # (dmax,4,S*M)
    level_active = torch.zeros((d_max, s), dtype=torch.int32)
    for si, d in enumerate(depths):
        level_active[:d, si] = 1
    active = (level_active.to(dev)[:, :, None].expand(d_max, s, m)
              .reshape(d_max, s * m).contiguous())
    return node, idx_flat, sib, active


def _merkle_planes_verdict(H, leaf_datas, idxs, sibs, depths, caps,
                           cap_index):
    """The leaves through the hasher's leaf kernel, the paths through its
    path kernel, the roots compared with the cap entries -> (B, Q, S)
    (counterpart of `_gl_merkle_planes_verdict` and
    `_bn254_merkle_planes_verdict` in the JAX package's fri.py)."""
    node, idx, sib, active = _stack_paths(leaf_datas, idxs, sibs, depths,
                                          max(depths), H.leaf_hash)
    with scope("two_to_one"):
        out = H.verify_paths(node, sib, idx, active)                # (4, S*M)
    b, q = cap_index.shape
    got = out.reshape(4, len(caps), b, q).permute(2, 3, 1, 0)       # (B,Q,S,4)
    root = H.take_cap(H.stack(caps, 1), cap_index)                  # (B,Q,S,4)
    return H.eq(root, got)


def merged_merkle_checks(S, H, batch, x_index, cap_index):
    """Every Merkle path check of one verification, stacked on one slot
    axis.  Returns (B, Q, S) booleans."""
    leaf_datas, idxs, sibs, depths, caps = [], [], [], [], []
    for oi in range(len(S.oracle_widths)):
        leaf_datas.append(batch.initial_evals[oi])               # (B,Q,w)
        idxs.append(x_index)
        sibs.append(batch.initial_siblings[oi])                  # (B,Q,D,4)
        depths.append(S.initial_depth)
    caps.extend(batch.oracle_caps())

    cum = 0
    for si, ab in enumerate(S.reduction_arity_bits):
        cum += ab
        ev = batch.step_evals[si]                                # (B,Q,arity,2)
        leaf_datas.append(ev.reshape(ev.shape[:2] + (-1,)))      # (B,Q,2*arity)
        idxs.append(x_index >> cum)
        sibs.append(batch.step_siblings[si])
        depths.append(S.step_depths[si])
        caps.append(batch.commit_caps[si])

    return _merkle_planes_verdict(H, leaf_datas, idxs, sibs, depths, caps,
                                  cap_index)


def _bcast_ext(e, shape):
    """Broadcast an ext value of batch shape (B,) to (B, Q)."""
    return (e[0][:, None].expand(shape), e[1][:, None].expand(shape))


@count
def verify_fri(shape, batch, challenges, verdict):
    """FRI verification; returns the updated (B,) verdict.

    challenges: fri_alpha (ext (B,)), fri_betas (list of ext),
    fri_pow_response ((B,)), query_lo ((B, Q) low words of the query
    challenges), instance_batches (list of (point ext, [(oracle, poly)])),
    openings_batches (list of lists of ext (B,) values).
    """
    S = shape
    H = get_hash_ops(shape.hasher)
    b = batch.batch_size
    dev = batch.device
    q = challenges["query_lo"].shape[-1]
    n_log = S.lde_bits
    assert n_log < 32
    bq = (b, q)

    # proof of work
    verdict = verdict & gl.lt_pow2(challenges["fri_pow_response"],
                                   64 - S.proof_of_work_bits)

    # query indices
    x_index = challenges["query_lo"] & ((1 << n_log) - 1)           # (B, Q)
    cap_index = x_index >> S.initial_depth                          # top bits

    # subgroup_x = 7 * phi^bitrev(x_index)
    with scope("subgroup_x"):
        rev = bit_reverse_u32(x_index, n_log)
        phi_pow = exp_from_bits_const_base(rev, _pow_root_consts(n_log),
                                           n_log)
        subgroup_x = gl.mul(gl.full(bq, gl.GENERATOR, dev), phi_pow)

    # reduced openings
    alpha = challenges["fri_alpha"]
    reduced_openings = [gle.reduce_with_powers(vals, alpha)
                        for vals in challenges["openings_batches"]]

    # combine_initial
    with scope("combine_initial"):
        old_eval = _combine_initial(batch, challenges, reduced_openings,
                                    subgroup_x, bq)

    # merged Merkle checks
    with scope("verify_merkle_proofs"):
        mk_ok = merged_merkle_checks(S, H, batch, x_index, cap_index)
        verdict = verdict & mk_ok.all(dim=2).all(dim=1)

    # reduction steps
    idx_cur = x_index
    for si, ab in enumerate(S.reduction_arity_bits):
        arity = 1 << ab
        within = idx_cur & (arity - 1)                              # (B, Q)
        ev = batch.step_evals[si]                                   # (B,Q,arity,2)
        picked = ev.gather(2, within[:, :, None, None].expand(b, q, 1, 2))
        new_eval = (picked[:, :, 0, 0], picked[:, :, 0, 1])
        verdict = verdict & gle.eq(new_eval, old_eval).all(dim=1)
        with scope("compute_evaluation"):
            old_eval = _compute_evaluation(subgroup_x, within, ab, ev,
                                           challenges["fri_betas"][si], bq)
        subgroup_x = gl.exp_power_of_2(subgroup_x, ab)
        idx_cur = idx_cur >> ab

    # final polynomial: Horner over the coefficients, highest first
    fp = batch.final_poly                                           # (B, L, 2)
    sx_ext = gle.from_base(subgroup_x)
    acc = gle.zeros_like(sx_ext)
    with scope("final_poly_eval"):
        for i in reversed(range(fp.shape[1])):
            c = (fp[:, i, 0][:, None], fp[:, i, 1][:, None])        # over Q
            acc = gle.add(gle.mul(acc, sx_ext), c)
    return verdict & gle.eq(acc, old_eval).all(dim=1)


def _combine_initial(batch, challenges, reduced_openings, subgroup_x, bq):
    """The initial combined evaluation of every query (fri/mod.rs:170-220):
    sum over the opening batches of (reduced evals - reduced openings) /
    (subgroup_x - point), alpha-shifted batch by batch."""
    alpha_bq = _bcast_ext(challenges["fri_alpha"], bq)
    sx_ext = gle.from_base(subgroup_x)
    denoms = [gle.sub(sx_ext, _bcast_ext(point, bq))
              for (point, _) in challenges["instance_batches"]]
    if len(denoms) == 2:
        denom_invs = list(gle.inv_pair(denoms[0], denoms[1]))
    else:
        denom_invs = [gle.inv(d) for d in denoms]
    total = gle.zeros_like(sx_ext)
    for (point, polys), red_open, denom_inv in zip(
            challenges["instance_batches"], reduced_openings, denom_invs):
        evals = [gle.from_base(batch.initial_evals[oi][..., pi])
                 for (oi, pi) in polys]
        reduced_evals = gle.reduce_with_powers(evals, alpha_bq)
        numerator = gle.sub(reduced_evals, _bcast_ext(red_open, bq))
        alpha_shift = gle.exp_const(alpha_bq, len(evals))
        total = gle.mul(alpha_shift, total)
        total = gle.add(gle.mul(numerator, denom_inv), total)
    return total


def _compute_evaluation(x, within, arity_bits, evals, beta, bq):
    """Barycentric fold: the value at beta of the polynomial interpolating
    the coset's evals (fri/mod.rs:286-322, interpolate_coset 223-283)."""
    dev = x.device
    arity = 1 << arity_bits
    g = gl.primitive_root_of_unity(arity_bits)
    g_inv = pow(g, arity - 1, gl.P)
    ginv_pows = []
    cur = g_inv
    for _ in range(arity_bits):
        ginv_pows.append(cur)
        cur = cur * cur % gl.P
    rev_within = bit_reverse_u32(within, arity_bits)
    start = exp_from_bits_const_base(rev_within, ginv_pows, arity_bits)
    coset_start = gl.mul(start, x)

    # interpolate over two_adic_subgroup(arity_bits); values bit-reversed
    brv = gl.reverse_index_bits(list(range(arity)))
    domain = gl.two_adic_subgroup(arity_bits)
    weights = _barycentric_weights_host(domain)
    shifted = gle.scalar_mul(_bcast_ext(beta, bq), gl.inv(coset_start))

    ev_acc = gle.zeros_like(shifted)
    partial = (gl.full(bq, 1, dev), gl.zeros(bq, dev))
    for i in range(arity):
        e_i = (evals[:, :, brv[i], 0], evals[:, :, brv[i], 1])
        val = gle.scalar_mul(e_i, gl.full(bq, weights[i], dev))
        term = gle.sub(shifted, gle.from_base(gl.full(bq, domain[i], dev)))
        ev_acc = gle.add(gle.mul(ev_acc, term), gle.mul(val, partial))
        partial = gle.mul(partial, term)
    return ev_acc


def _barycentric_weights_host(domain):
    """w_i = 1 / prod_{j != i} (x_i - x_j) over host ints."""
    prods = []
    for i, xi in enumerate(domain):
        acc = 1
        for j, xj in enumerate(domain):
            if j != i:
                acc = acc * ((xi - xj) % gl.P) % gl.P
        prods.append(acc)
    return gl.batch_inv_host(prods)

"""The benchmark's reference: a starky verifier over many proofs at once,
written from the pure-int reference verifier of the JAX package (frozen
here; it imports neither JAX nor anything of the verifier under test).

`verify_lanes(geom, fields)` takes L proofs as the benchmark hands
them to the program, {field: uint64 array with a leading lane axis}, and
returns an (L,) bool verdict.  A proof is accepted when every check of
starky's verifier holds:

  - range: every Goldilocks value below p, every BN254 hash below the BN254
    modulus (the witness range checks: a value and its alias mod p are
    different proofs);
  - the challenges (plonky2's challenger, `challenger/mod.rs`), run for all
    lanes at once in `gl_numpy.Challenger`;
  - the vanishing polynomial at zeta against the quotient (starky's
    `eval_vanishing_poly`, permutation argument included), per lane;
  - FRI (`fri/mod.rs`): the proof of work, every Merkle path to its cap
    (Goldilocks: all lanes and queries at once in numpy; BN254: Python ints,
    memoised), the initial combination, each fold with its consistency
    check, and the final polynomial, per lane and query.

Lanes that fail a cheap check skip the costly ones: the verdict is the AND
either way.
"""

from itertools import product as iter_product

import numpy as np

from . import field as gl
from . import gl_numpy as gn
from . import poseidon_bn254 as pb
from .constants import P_BN254
from .geometry import stark_model

HASH_FIELDS = ("trace_cap", "zs_cap", "quotient_cap", "commit_caps",
               "initial_siblings", "step_siblings")
_R_WORDS = [np.uint64((P_BN254 >> (64 * k)) & ((1 << 64) - 1))
            for k in range(4)]
_M56 = (1 << 56) - 1


def _arrays(v):
    return v if isinstance(v, list) else [v]


def bn254_below_modulus(words):
    """(..., 4) little-endian u64 words -> (...,) bool: the value < r."""
    lt = np.zeros(words.shape[:-1], dtype=bool)
    eq = np.ones(words.shape[:-1], dtype=bool)
    for k in (3, 2, 1, 0):
        w = words[..., k]
        lt |= eq & (w < _R_WORDS[k])
        eq &= w == _R_WORDS[k]
    return lt


def in_range(geom, f):
    """(L,) bool: every value of a lane canonical."""
    lanes = len(f["pow_witness"])
    ok = np.ones(lanes, dtype=bool)
    for name, v in f.items():
        for a in _arrays(v):
            if name in HASH_FIELDS and geom.hasher == "poseidon_bn254":
                good = bn254_below_modulus(a)
            else:
                good = a < gn.P
            ok &= good.reshape(lanes, -1).all(axis=1)
    return ok


def cap_elements(geom, cap):
    """(L, cap, 4) hashes -> (L, k) Goldilocks elements as the transcript
    observes them: a Goldilocks hash itself, a BN254 hash as the five
    56-bit limbs of its value (`hash.rs:30-43`)."""
    lanes = cap.shape[0]
    if geom.hasher == "poseidon_goldilocks":
        return cap.reshape(lanes, -1)
    w = [cap[..., k] for k in range(4)]
    m = np.uint64(_M56)

    def sh(x):
        return np.uint64(x)

    limbs = [w[0] & m,
             (w[0] >> sh(56)) | ((w[1] & sh((1 << 48) - 1)) << sh(8)),
             (w[1] >> sh(48)) | ((w[2] & sh((1 << 40) - 1)) << sh(16)),
             (w[2] >> sh(40)) | ((w[3] & sh((1 << 32) - 1)) << sh(24)),
             w[3] >> sh(32)]
    return np.stack(limbs, axis=-1).reshape(lanes, -1)


def challenges(geom, f):
    """Every challenge of every lane, in `get_stark_challenges`' order.
    Base-field challenges are (L,) arrays, extension ones pairs of them."""
    if geom.transcript != "poseidon_goldilocks":
        raise NotImplementedError(f"transcript {geom.transcript}")
    lanes = len(f["pow_witness"])
    ch = gn.Challenger(lanes)
    nc = geom.num_challenges
    ch.observe(cap_elements(geom, f["trace_cap"]))
    perm_sets = [[(ch.challenge(), ch.challenge()) for _ in range(nc)]
                 for _ in range(geom.num_challenge_sets)]
    ch.observe(cap_elements(geom, f["zs_cap"]))
    alphas = [ch.challenge() for _ in range(nc)]
    ch.observe(cap_elements(geom, f["quotient_cap"]))
    zeta = ch.ext_challenge()
    for name in ("local_values", "permutation_zs", "quotient_polys",
                 "next_values", "permutation_zs_next"):
        ch.observe(f[name].reshape(lanes, -1))
    fri_alpha = ch.ext_challenge()
    betas = []
    for cap in f["commit_caps"]:
        ch.observe(cap_elements(geom, cap))
        betas.append(ch.ext_challenge())
    ch.observe(f["final_poly"].reshape(lanes, -1))
    ch.observe(f["pow_witness"].reshape(lanes, 1))
    pow_response = ch.challenge()
    queries = np.stack([ch.challenge() for _ in range(geom.num_queries)],
                       axis=1)
    return {"perm_sets": perm_sets, "alphas": alphas, "zeta": zeta,
            "fri_alpha": fri_alpha, "betas": betas,
            "pow_response": pow_response, "queries": queries}


# ----------------------------------------------------------------------------
# per lane: the vanishing polynomial at zeta
# ----------------------------------------------------------------------------

class ExtOps:
    """GF(p^2) with (a0, a1) tuples, for the AIR's `eval`."""
    zero = staticmethod(lambda: gl.EXT_ZERO)
    one = staticmethod(lambda: gl.EXT_ONE)
    add = staticmethod(gl.ext_add)
    sub = staticmethod(gl.ext_sub)
    mul = staticmethod(gl.ext_mul)
    from_base = staticmethod(gl.ext_from_base)


class ConstraintConsumer:
    """starky's ConstraintConsumer: acc = acc * alpha + c per alpha, with
    the row selectors."""

    def __init__(self, alphas, z_last, lagrange_first, lagrange_last):
        self.alphas = alphas
        self.z_last = z_last
        self.lagrange_first = lagrange_first
        self.lagrange_last = lagrange_last
        self.accumulators = [gl.EXT_ZERO for _ in alphas]

    def constraint(self, c):
        self.accumulators = [gl.ext_add(gl.ext_mul(acc, a), c)
                             for acc, a in zip(self.accumulators, self.alphas)]

    def constraint_transition(self, c):
        self.constraint(gl.ext_mul(c, self.z_last))

    def constraint_first_row(self, c):
        self.constraint(gl.ext_mul(c, self.lagrange_first))

    def constraint_last_row(self, c):
        self.constraint(gl.ext_mul(c, self.lagrange_last))


def _ext_rows(a):
    return [(int(x), int(y)) for x, y in a]


def _permutation_checks(model, geom, local, zs, zs_next, perm_sets, consumer):
    """starky's `eval_permutation_checks`: Z(first row) = 1 for each Z,
    then Z(gx) prod(rhs) - Z(x) prod(lhs) over each batch of instances."""
    one = gl.EXT_ONE
    for z in zs:
        consumer.constraint_first_row(gl.ext_sub(z, one))
    instances = list(iter_product(model.PERMUTATION_PAIRS,
                                  range(geom.num_challenges)))
    size = geom.num_challenge_sets
    for b, start in enumerate(range(0, len(instances), size)):
        red_l_prod = red_r_prod = one
        for i, (pairs, chal) in enumerate(instances[start:start + size]):
            beta, gamma = perm_sets[i][chal]
            red_l = red_r = gl.ext_from_base(gamma)
            w = one
            for lhs, rhs in pairs:
                red_l = gl.ext_add(red_l, gl.ext_mul(w, local[lhs]))
                red_r = gl.ext_add(red_r, gl.ext_mul(w, local[rhs]))
                w = gl.ext_mul(w, gl.ext_from_base(beta))
            red_l_prod = gl.ext_mul(red_l_prod, red_l)
            red_r_prod = gl.ext_mul(red_r_prod, red_r)
        consumer.constraint(gl.ext_sub(gl.ext_mul(zs_next[b], red_r_prod),
                                       gl.ext_mul(zs[b], red_l_prod)))


def vanishing_ok(geom, f, ch, i):
    """Z_H(zeta) quotient(zeta) == the alpha-folded constraints at zeta,
    for each challenge, on lane i."""
    model = stark_model(geom.stark)
    zeta = (int(ch["zeta"][0][i]), int(ch["zeta"][1][i]))
    db = geom.degree_bits
    n = 1 << db
    g_sub = gl.primitive_root_of_unity(db)
    one = gl.EXT_ONE
    zeta_pow_n = gl.ext_exp_power_of_2(zeta, db)
    z_h = gl.ext_sub(zeta_pow_n, one)
    try:
        l0 = gl.ext_mul(z_h, gl.ext_inv(
            gl.ext_scalar_mul(gl.ext_sub(zeta, one), n)))
        llast = gl.ext_mul(z_h, gl.ext_inv(gl.ext_scalar_mul(
            gl.ext_sub(gl.ext_scalar_mul(zeta, g_sub), one), n)))
    except ZeroDivisionError:
        return False
    z_last = gl.ext_sub(zeta, gl.ext_from_base(pow(g_sub, n - 1, gl.P)))
    alphas = [gl.ext_from_base(int(a[i])) for a in ch["alphas"]]
    consumer = ConstraintConsumer(alphas, z_last, l0, llast)
    local = _ext_rows(f["local_values"][i])
    nxt = _ext_rows(f["next_values"][i])
    pis = [gl.ext_from_base(int(x)) for x in f["public_inputs"][i]]
    model.eval(ExtOps, local, nxt, pis, consumer)
    perm_sets = [[(int(b[i]), int(g[i])) for b, g in cset]
                 for cset in ch["perm_sets"]]
    _permutation_checks(model, geom, local, _ext_rows(f["permutation_zs"][i]),
                        _ext_rows(f["permutation_zs_next"][i]), perm_sets,
                        consumer)
    quotient = _ext_rows(f["quotient_polys"][i])
    factor = geom.num_quotient // geom.num_challenges
    for k, acc in enumerate(consumer.accumulators):
        chunk = quotient[k * factor:(k + 1) * factor]
        recombined = gl.reduce_with_powers_ext(chunk, zeta_pow_n)
        if gl.ext_mul(z_h, recombined) != acc:
            return False
    return True


# ----------------------------------------------------------------------------
# Merkle paths
# ----------------------------------------------------------------------------

def _path_groups(geom, f, lanes, x_index):
    """Each Merkle tree a query opens: (leaves (l, Q, k), leaf index (l, Q),
    siblings (l, Q, depth, 4), caps (l, cap, 4), depth)."""
    groups = []
    caps = [f["trace_cap"], f["zs_cap"], f["quotient_cap"]]
    for oi in range(3):
        groups.append((f["initial_evals"][oi][lanes], x_index,
                       f["initial_siblings"][oi][lanes], caps[oi][lanes],
                       geom.initial_depth))
    cum = 0
    for si, ab in enumerate(geom.reduction_arity_bits):
        cum += ab
        ev = f["step_evals"][si][lanes]
        groups.append((ev.reshape(ev.shape[:2] + (-1,)), x_index >> cum,
                       f["step_siblings"][si][lanes], f["commit_caps"][si][lanes],
                       geom.step_depths[si]))
    return groups


def merkle_gl(geom, f, lanes, x_index):
    """(l,) bool: every path of each lane reaches its cap entry, all lanes,
    queries and trees of one depth walked together."""
    l, q = x_index.shape
    ok = np.ones(l, dtype=bool)
    by_depth = {}
    for leaves, idx, sib, cap, depth in _path_groups(geom, f, lanes,
                                                     x_index):
        node = gn.hash_or_noop(leaves.reshape(l * q, -1))
        by_depth.setdefault(depth, []).append(
            (node, idx.reshape(-1), sib.reshape(l * q, depth, 4), cap))
    rows = np.repeat(np.arange(l), q)
    for depth, trees in by_depth.items():
        node = np.concatenate([t[0] for t in trees])
        idx = np.concatenate([t[1] for t in trees])
        sib = np.concatenate([t[2] for t in trees])
        for d in range(depth):
            right = ((idx >> np.uint64(d)) & np.uint64(1)).astype(bool)[:, None]
            s = sib[:, d]
            node = gn.two_to_one(np.where(right, s, node),
                                 np.where(right, node, s))
        cap_idx = (idx >> np.uint64(depth)).astype(np.int64)
        for k, (_, _, _, cap) in enumerate(trees):
            part = slice(k * l * q, (k + 1) * l * q)
            root = cap[rows, cap_idx[part]]
            ok &= (node[part] == root).all(axis=1).reshape(l, q).all(axis=1)
    return ok


def _fr(words):
    return sum(int(w) << (64 * k) for k, w in enumerate(words))


def merkle_bn254(geom, f, lanes, x_index, hasher):
    """(l,) bool, as `merkle_gl`, path by path in Python ints."""
    l, q = x_index.shape
    ok = np.ones(l, dtype=bool)
    for leaves, idx, sib, cap, depth in _path_groups(geom, f, lanes,
                                                     x_index):
        for a in range(l):
            for j in range(q):
                if not ok[a]:
                    break
                node = hasher.leaf([int(x) for x in leaves[a, j].reshape(-1)])
                index = int(idx[a, j])
                for d in range(depth):
                    s = _fr(sib[a, j, d])
                    node = (hasher.node(s, node) if index & 1
                            else hasher.node(node, s))
                    index >>= 1
                if _fr(cap[a, index]) != node:
                    ok[a] = False
    return ok


# ----------------------------------------------------------------------------
# per lane and query: FRI's arithmetic
# ----------------------------------------------------------------------------

_WEIGHTS = {}


def _barycentric(arity_bits):
    if arity_bits not in _WEIGHTS:
        domain = gl.two_adic_subgroup(arity_bits)
        dens = []
        for i, x_i in enumerate(domain):
            acc = 1
            for j, x_j in enumerate(domain):
                if j != i:
                    acc = acc * (x_i - x_j) % gl.P
            dens.append(acc)
        _WEIGHTS[arity_bits] = (domain, gl.batch_inv(dens))
    return _WEIGHTS[arity_bits]


def _reverse_bits(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _compute_evaluation(x, x_within, arity_bits, evals, beta):
    """One FRI fold: the coset's values interpolated at beta
    (`fri/mod.rs:223-322`)."""
    arity = 1 << arity_bits
    g = gl.primitive_root_of_unity(arity_bits)
    g_inv = pow(g, arity - 1, gl.P)
    evals_brv = [None] * arity
    for k, e in enumerate(evals):
        evals_brv[_reverse_bits(k, arity_bits)] = e
    coset_start = pow(g_inv, _reverse_bits(x_within, arity_bits), gl.P) * x \
        % gl.P
    shifted = gl.ext_scalar_mul(beta, gl.inv(coset_start))
    domain, weights = _barycentric(arity_bits)
    ev, partial = gl.EXT_ZERO, gl.EXT_ONE
    for val, w, x_i in zip(evals_brv, weights, domain):
        term = gl.ext_sub(shifted, gl.ext_from_base(x_i))
        ev = gl.ext_add(gl.ext_mul(ev, term),
                        gl.ext_mul(gl.ext_scalar_mul(val, w), partial))
        partial = gl.ext_mul(partial, term)
    return ev


def fri_ok(geom, f, ch, i):
    """The FRI arithmetic of lane i over all its queries: the initial
    combination, each fold's consistency, the final polynomial."""
    alpha = (int(ch["fri_alpha"][0][i]), int(ch["fri_alpha"][1][i]))
    betas = [(int(b[0][i]), int(b[1][i])) for b in ch["betas"]]
    zeta = (int(ch["zeta"][0][i]), int(ch["zeta"][1][i]))
    zeta_next = gl.ext_mul(
        gl.ext_from_base(gl.primitive_root_of_unity(geom.degree_bits)), zeta)
    local = _ext_rows(f["local_values"][i])
    zs = _ext_rows(f["permutation_zs"][i])
    quot = _ext_rows(f["quotient_polys"][i])
    nxt = _ext_rows(f["next_values"][i])
    zs_next = _ext_rows(f["permutation_zs_next"][i])
    # (point, [(oracle, poly)]) per batch: zeta opens every oracle, zeta g
    # the trace and the Zs
    widths = geom.oracle_widths
    batches = [(zeta, [(o, p) for o in range(3) for p in range(widths[o])]),
               (zeta_next, [(o, p) for o in range(2) for p in range(widths[o])])]
    reduced = [gl.reduce_with_powers_ext(local + zs + quot, alpha),
               gl.reduce_with_powers_ext(nxt + zs_next, alpha)]
    final_poly = _ext_rows(f["final_poly"][i])
    n_log = geom.lde_bits
    phi = gl.primitive_root_of_unity(n_log)
    for qi in range(geom.num_queries):
        x_index = int(ch["queries"][i, qi]) % (1 << n_log)
        x = gl.GENERATOR * pow(phi, _reverse_bits(x_index, n_log), gl.P) \
            % gl.P
        x_ext = gl.ext_from_base(x)
        evals = [[int(v) for v in f["initial_evals"][o][i, qi]]
                 for o in range(3)]
        total = gl.EXT_ZERO
        for (point, polys), red in zip(batches, reduced):
            terms = [gl.ext_from_base(evals[o][p]) for o, p in polys]
            num = gl.ext_sub(gl.reduce_with_powers_ext(terms, alpha), red)
            den = gl.ext_sub(x_ext, point)
            if den == gl.EXT_ZERO:
                return False
            total = gl.ext_mul(gl.ext_exp(alpha, len(terms)), total)
            total = gl.ext_add(gl.ext_mul(num, gl.ext_inv(den)), total)
        old = total
        xi = x_index
        for si, ab in enumerate(geom.reduction_arity_bits):
            step = _ext_rows(f["step_evals"][si][i, qi])
            within = xi & ((1 << ab) - 1)
            if step[within] != old:
                return False
            old = _compute_evaluation(x, within, ab, step, betas[si])
            x = gl.exp_power_of_2(x, ab)
            xi >>= ab
        acc = gl.EXT_ZERO
        for c in reversed(final_poly):
            acc = gl.ext_add(gl.ext_mul(acc, gl.ext_from_base(x)), c)
        if acc != old:
            return False
    return True


def verify_lanes(geom, f):
    """(L,) bool verdicts of L proofs."""
    ok = in_range(geom, f)
    ch = challenges(geom, f)
    for i in np.flatnonzero(ok):
        ok[i] = vanishing_ok(geom, f, ch, i)
    ok &= ch["pow_response"] < np.uint64(1 << (64 - geom.proof_of_work_bits))
    live = np.flatnonzero(ok)
    if len(live):
        x_index = ch["queries"][live] % np.uint64(1 << geom.lde_bits)
        if geom.hasher == "poseidon_goldilocks":
            ok[live] = merkle_gl(geom, f, live, x_index)
        else:
            ok[live] = merkle_bn254(geom, f, live, x_index, pb.Hasher())
    for i in np.flatnonzero(ok):
        ok[i] = fri_ok(geom, f, ch, i)
    return ok

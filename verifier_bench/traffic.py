"""The one traffic generator: batches of proofs drawn from a seed.

A traffic file (`traffic/<name>.json`) gives the rows of the proofs, the
batch, the verifies in flight, the batches cycled in the window, the
tampered lanes a batch and the batches traced.  From `--seed` the generator
draws, for each cycled batch, which distinct proof fills each lane, which
lanes are tampered, and each tamper's kind, position and value.  Every seed
gives the same sizes and the same count of each kind, in another order.

A tamper is a list of writes (field, list index or None, index inside the
proof, new uint64 value), made on the host from the proof the lane holds;
the program's batch and the reference's lanes get the same writes.  The
kinds are cycled so that each appears in every batch, and each is decided
by another layer of the verifier:

  pow_witness   a bit of the proof-of-work witness (transcript, PoW check)
  trace_cap     a trace-cap word (transcript and Merkle)
  late_sibling  a sibling of a query in the second half (Merkle only)
  opening       a local or next value, half of them made non-canonical
                (the vanishing check, or the range check)
  initial_eval  an initial-tree opening (FRI's initial combination)
  step          a step opening or a commit-phase cap word (the folds;
                only where the proofs have folds)
  final_poly    a final-polynomial coefficient (FRI's final check)
  public_input  a public input (the vanishing check's boundary rows)
  cap_raised    a BN254 cap element raised by the BN254 modulus: the same
                residue, out of range (BN254 caps only)
"""

import numpy as np

from .reference.constants import GOLDILOCKS_PRIME as P, P_BN254

KINDS = ("pow_witness", "trace_cap", "late_sibling", "opening",
         "initial_eval", "step", "final_poly", "public_input", "cap_raised")


def kinds_for(geom):
    """The tamper kinds these proofs can have."""
    out = [k for k in KINDS
           if (k != "step" or geom.reduction_arity_bits)
           and (k != "cap_raised" or geom.hasher == "poseidon_bn254")]
    return tuple(out)


def _get(fields, field, li):
    v = fields[field]
    return v if li is None else v[li]


def _bump(rng, value):
    return (int(value) + int(rng.integers(1, P, dtype=np.uint64))) % P


def _hash_word_bump(rng, geom, value):
    """A hash word changed: a Goldilocks element stays in range; a BN254
    word moves by less than 2^32."""
    if geom.hasher == "poseidon_goldilocks":
        return _bump(rng, value)
    return (int(value) + int(rng.integers(1, 1 << 32))) % (1 << 64)


def make_tamper(kind, rng, geom, fields, src):
    """The writes of one tamper of `kind` on distinct proof `src`."""
    q = geom.num_queries

    def at(field, li, index):
        return int(_get(fields, field, li)[(src,) + index])

    if kind == "pow_witness":
        bit = int(rng.integers(0, 32))
        return [("pow_witness", None, (), at("pow_witness", None, ()) ^ (1 << bit))]
    if kind == "trace_cap":
        i = (int(rng.integers(geom.cap_size)), int(rng.integers(4)))
        return [("trace_cap", None, i,
                 _hash_word_bump(rng, geom, at("trace_cap", None, i)))]
    if kind == "late_sibling":
        o = int(rng.integers(3))
        i = (int(rng.integers(q // 2, q)), int(rng.integers(geom.initial_depth)),
             int(rng.integers(4)))
        return [("initial_siblings", o, i,
                 _hash_word_bump(rng, geom, at("initial_siblings", o, i)))]
    if kind == "opening":
        field = ("local_values", "next_values")[int(rng.integers(2))]
        i = (int(rng.integers(geom.columns)), int(rng.integers(2)))
        if rng.integers(2):
            return [(field, None, i, P + int(rng.integers(0, (1 << 32) - 1)))]
        return [(field, None, i, _bump(rng, at(field, None, i)))]
    if kind == "initial_eval":
        o = int(rng.integers(3))
        i = (int(rng.integers(q)), int(rng.integers(geom.oracle_widths[o])))
        return [("initial_evals", o, i, _bump(rng, at("initial_evals", o, i)))]
    if kind == "step":
        s = int(rng.integers(len(geom.reduction_arity_bits)))
        if rng.integers(2):
            i = (int(rng.integers(q)),
                 int(rng.integers(1 << geom.reduction_arity_bits[s])),
                 int(rng.integers(2)))
            return [("step_evals", s, i, _bump(rng, at("step_evals", s, i)))]
        i = (int(rng.integers(geom.cap_size)), int(rng.integers(4)))
        return [("commit_caps", s, i,
                 _hash_word_bump(rng, geom, at("commit_caps", s, i)))]
    if kind == "final_poly":
        i = (int(rng.integers(geom.final_poly_len)), int(rng.integers(2)))
        return [("final_poly", None, i, _bump(rng, at("final_poly", None, i)))]
    if kind == "public_input":
        i = (int(rng.integers(geom.public_inputs)),)
        return [("public_inputs", None, i,
                 _bump(rng, at("public_inputs", None, i)))]
    if kind == "cap_raised":
        caps = [("trace_cap", None), ("zs_cap", None), ("quotient_cap", None)]
        caps += [("commit_caps", s) for s in range(len(geom.reduction_arity_bits))]
        field, li = caps[int(rng.integers(len(caps)))]
        c = int(rng.integers(geom.cap_size))
        words = _get(fields, field, li)[src, c]
        v = sum(int(w) << (64 * k) for k, w in enumerate(words)) + P_BN254
        return [(field, li, (c, k), (v >> (64 * k)) & ((1 << 64) - 1))
                for k in range(4)]
    raise ValueError(f"unknown tamper kind {kind!r}")


def make_plan(seed, traffic, geom, fields):
    """For each cycled batch: `sources` (B,) the distinct proof of each
    lane, and `tampers`, a list of (lane, kind, writes)."""
    rng = np.random.default_rng(seed)
    n_distinct = len(fields["pow_witness"])
    kinds = kinds_for(geom)
    size, count = traffic["batch"], traffic["tampered_lanes"]
    plan = []
    for _ in range(traffic["batches_cycled"]):
        sources = rng.integers(0, n_distinct, size=size)
        lanes = rng.choice(size, size=count, replace=False)
        start = int(rng.integers(len(kinds)))
        tampers = []
        for j, lane in enumerate(lanes):
            kind = kinds[(start + j) % len(kinds)]
            tampers.append((int(lane), kind, make_tamper(
                kind, rng, geom, fields, int(sources[lane]))))
        plan.append({"sources": sources, "tampers": tampers})
    return plan


def apply_writes(fields, lane, writes):
    """Write a tamper into lane `lane` of host arrays, in place."""
    for field, li, index, value in writes:
        _get(fields, field, li)[(lane,) + index] = np.uint64(value)


def reference_lanes(plan, fields):
    """The lanes the reference verifies: every distinct proof, then every
    tampered lane of every batch, as one {field: array} of lanes."""
    n_distinct = len(fields["pow_witness"])
    srcs = list(range(n_distinct))
    tampered = [(int(b["sources"][lane]), writes)
                for b in plan for lane, _, writes in b["tampers"]]
    idx = np.array(srcs + [s for s, _ in tampered], dtype=np.int64)
    out = {k: ([a[idx] for a in v] if isinstance(v, list) else v[idx])
           for k, v in fields.items()}
    for j, (_, writes) in enumerate(tampered):
        apply_writes(out, n_distinct + j, writes)
    return out


def expected(plan, verdicts, n_distinct):
    """Per cycled batch, the (B,) verdict the reference gives each lane:
    a lane holds a distinct proof, or one of the tampered lanes."""
    out, j = [], n_distinct
    for b in plan:
        exp = verdicts[:n_distinct][b["sources"]].copy()
        for lane, _, _ in b["tampers"]:
            exp[lane] = verdicts[j]
            j += 1
        out.append(exp)
    return out

"""The plonky2 gate set's constraint evaluators, and the selector filters.

The verifier half of `halo2_plonky2_verifier_tpu/refimpl/plonk/gates.py`:
the 16 gate classes' `id`, `degree`, `num_constraints` and `eval` (the 14 of
plonky2's standard_recursion mix, plus the two logUp gates, whose
constraints live in `vanishing.lookup_terms`), `_mul_const`, the `_alg_*`
helpers, `compute_selector_groups`, `compute_filter` and
`evaluate_gate_constraints`.  The witness-generation hooks (`fill`) and the
circuit builder stay in the JAX package.

Gate semantics follow plonky2's gates/:
  - each gate row has one gate; selector polynomial s_g(x) holds the gate's
    index within the circuit's gate list (or UNUSED for rows outside group g);
  - the filter for gate i in selector group [a, b) is
        prod_{k in [a,b), k != i} (k - s) [* (UNUSED - s) if many groups]
    and every one of the gate's constraints is multiplied by it;
  - gate `eval` is written against a field-ops adapter F, the port's
    `stark.ExtOps` over batched extension tensors.

`gate_from_json` rebuilds a gate from the (id, params) pair a circuit
fixture holds, through `GATE_PARAMS`, and refuses a gate whose rebuilt id
differs from the stored one.
"""

from ..constants.poseidon_goldilocks import (ALL_ROUND_CONSTANTS,
                                             HALF_N_FULL_ROUNDS,
                                             MDS_MATRIX_CIRC, MDS_MATRIX_DIAG,
                                             N_PARTIAL_ROUNDS)
from ..ops import goldilocks as gl

UNUSED_SELECTOR = (1 << 32) - 1


class Gate:
    """One plonky2 gate type.  Subclasses define:
    id(), num_wires, num_constants, degree(), num_constraints(),
    eval(F, constants, wires, public_inputs_hash) -> list of constraints."""

    num_wires = 0
    num_constants = 0

    def id(self):
        return type(self).__name__

    def degree(self):
        raise NotImplementedError

    def num_constraints(self):
        return 0

    def eval(self, F, constants, wires, public_inputs_hash):
        return []


class NoopGate(Gate):
    """No constraints (plonky2 gates/noop.rs); also used for padding rows and
    as the host row for free public-input wires."""

    def degree(self):
        return 0


class ConstantGate(Gate):
    """wires[i] == constants[i] for i < num_consts (plonky2 gates/constant.rs)."""

    def __init__(self, num_consts):
        self.num_consts = num_consts
        self.num_wires = num_consts
        self.num_constants = num_consts

    def id(self):
        return f"ConstantGate(num_consts={self.num_consts})"

    def degree(self):
        return 1

    def num_constraints(self):
        return self.num_consts

    def eval(self, F, constants, wires, public_inputs_hash):
        return [F.sub(wires[i], constants[i]) for i in range(self.num_consts)]


class ArithmeticGate(Gate):
    """num_ops independent ops: out = c0 * m0 * m1 + c1 * addend, sharing the
    row constants c0, c1 (plonky2 gates/arithmetic_base.rs).  Wires per op:
    [multiplicand_0, multiplicand_1, addend, output]."""

    def __init__(self, num_ops):
        self.num_ops = num_ops
        self.num_wires = 4 * num_ops
        self.num_constants = 2

    def id(self):
        return f"ArithmeticGate(num_ops={self.num_ops})"

    def degree(self):
        return 3

    def num_constraints(self):
        return self.num_ops

    @staticmethod
    def wires_ith_op(i):
        return (4 * i, 4 * i + 1, 4 * i + 2, 4 * i + 3)

    def eval(self, F, constants, wires, public_inputs_hash):
        c0, c1 = constants[0], constants[1]
        xs = [tuple(wires[w] for w in self.wires_ith_op(i))
              for i in range(self.num_ops)]

        def body(carry, op):
            m0, m1, add, o = op
            computed = F.add(F.mul(c0, F.mul(m0, m1)), F.mul(c1, add))
            return carry, F.sub(computed, o)

        _, out = F.fold(body, F.zero(), xs)   # one scan over the ops
        return out


class PublicInputGate(Gate):
    """wires[0..4] == public-inputs hash (plonky2 gates/public_input.rs).
    The verifier recomputes the hash from the claimed public inputs, so
    tampering with them breaks these constraints."""

    num_wires = 4

    def degree(self):
        return 1

    def num_constraints(self):
        return 4

    def eval(self, F, constants, wires, public_inputs_hash):
        return [F.sub(wires[i], public_inputs_hash[i]) for i in range(4)]


class BaseSumGate(Gate):
    """Base-B decomposition with limb range checks (plonky2 gates/base_sum.rs):
    wires = [sum, limb_0, ..., limb_{n-1}], constraints:
      sum - sum_i limb_i * B^i                              (degree 1)
      prod_{v=0}^{B-1} (limb_i - v)  for each limb          (degree B)
    B=2 gives boolean decomposition — the framework's range-check gate."""

    def __init__(self, num_limbs, base=2):
        assert base >= 2
        self.num_limbs = num_limbs
        self.base = base
        self.num_wires = 1 + num_limbs
        self.num_constants = 0

    def id(self):
        return f"BaseSumGate(num_limbs={self.num_limbs}, base={self.base})"

    def degree(self):
        return self.base

    def num_constraints(self):
        return 1 + self.num_limbs

    def eval(self, F, constants, wires, public_inputs_hash):
        b = F.from_base(self.base)
        limbs = [wires[1 + i] for i in range(self.num_limbs)]

        def body(acc, limb):
            acc = F.add(F.mul(b, acc), limb)
            prod = limb
            for v in range(1, self.base):
                prod = F.mul(prod, F.sub(limb, F.from_base(v)))
            return acc, prod

        # one fold: the Horner recomposition (MSB-first) and each limb's
        # range product
        acc, prods = F.fold(body, F.zero(), list(reversed(limbs)))
        return [F.sub(wires[0], acc)] + list(reversed(prods))


class ExponentiationGate(Gate):
    """base^exponent by square-and-multiply over the exponent's bits
    (plonky2 gates/exponentiation.rs).  Wires: base (0), power bits LSB-first
    (1..num_power_bits), output (1+num_power_bits), intermediates (rest,
    unrouted).  Constraint i (MSB-first):
        intermediate_i = intermediate_{i-1}^2 * (bit * (base - 1) + 1)
    (degree 4; intermediate_{-1} = 1), plus output = last intermediate.
    Bits are NOT booleanity-constrained here — route them from a
    BaseSumGate(base=2) decomposition (CircuitBuilder.exp does)."""

    def __init__(self, num_power_bits):
        self.num_power_bits = num_power_bits
        self.num_wires = 2 + 2 * num_power_bits
        self.num_constants = 0

    def id(self):
        return f"ExponentiationGate(num_power_bits={self.num_power_bits})"

    def degree(self):
        return 4

    def num_constraints(self):
        return self.num_power_bits + 1

    def wire_bit(self, j):
        return 1 + j                      # LSB-first

    @property
    def wire_output(self):
        return 1 + self.num_power_bits

    def wire_intermediate(self, i):
        return 2 + self.num_power_bits + i

    def eval(self, F, constants, wires, public_inputs_hash):
        nb = self.num_power_bits
        one = F.one()
        base = wires[0]
        out = []
        prev = one
        for i in range(nb):
            bit = wires[self.wire_bit(nb - 1 - i)]   # MSB-first walk
            mult = F.add(F.mul(bit, F.sub(base, one)), one)
            cur = wires[self.wire_intermediate(i)]
            out.append(F.sub(F.mul(F.mul(prev, prev), mult), cur))
            prev = cur
        out.append(F.sub(wires[self.wire_output],
                         wires[self.wire_intermediate(nb - 1)]))
        return out


def _mul_const(F, c, x):
    """x * c for a small host-int constant c (MDS entries), through the ops
    adapter's mul_const_small (`stark.ExtOps`: two small-constant base
    products where a full extension product takes four base products and a
    constant fill)."""
    return F.mul_const_small(c, x)


class PoseidonGate(Gate):
    """The full Poseidon-Goldilocks permutation as one gate (plonky2
    gates/poseidon.rs: same 135-wire layout and 123-constraint count).

    Wires: 12 inputs (0..12), 12 outputs (12..24), swap (24, boolean: swap
    input halves 0..4 and 4..8 — Merkle two_to_one ordering), 4 deltas
    (25..29, delta_i = swap * (in[i+4] - in[i])), then intermediate state
    witnesses that keep every constraint's degree <= 7 (the x^7 S-box):

      - first-half full rounds r = 1..3: the 12-element state at round start
        (round 0 reads the swapped inputs directly — degree 1 via the delta
        wires), wires 29 + (r-1)*12 + i;
      - partial rounds r = 0..21: the S-box INPUT (state[0] after the
        constant layer), wire 65 + r — elements 1..11 stay implicit (they
        are linear combinations of earlier witnessed values, so their degree
        never exceeds 7);
      - second-half full rounds r = 0..3: the 12-element round-start state,
        wires 87 + r*12 + i (the first of these reads partial-round output
        whose components are degree-7 expressions, so all four rounds are
        witnessed).

    plonky2's eval uses the algebraically re-associated fast-partial-round
    constants; this gate constrains the mathematically identical naive form
    (constant layer -> S-box -> dense MDS), with the
    same wire count, constraint count, and degree."""

    W = 12
    WIRE_SWAP = 24
    num_wires = 135
    num_constants = 0

    def degree(self):
        return 7

    def num_constraints(self):
        return 1 + 4 + 36 + 22 + 48 + 12

    @staticmethod
    def wire_input(i):
        return i

    @staticmethod
    def wire_output(i):
        return 12 + i

    @staticmethod
    def wire_delta(i):
        return 25 + i

    @staticmethod
    def wire_full_first(r, i):
        assert 1 <= r < 4
        return 29 + (r - 1) * 12 + i

    @staticmethod
    def wire_partial(r):
        return 65 + r

    @staticmethod
    def wire_full_second(r, i):
        return 87 + r * 12 + i

    def _round_tables(self):
        assert HALF_N_FULL_ROUNDS == 4 and N_PARTIAL_ROUNDS == 22
        mds_rows = [[MDS_MATRIX_CIRC[(c - r) % 12]
                     + (MDS_MATRIX_DIAG[r] if r == c else 0)
                     for c in range(12)] for r in range(12)]
        return ALL_ROUND_CONSTANTS, mds_rows

    def eval(self, F, constants, wires, public_inputs_hash):
        rc, mds_rows = self._round_tables()
        one = F.one()
        out = []

        def sbox(x):
            x2 = F.mul(x, x)
            x4 = F.mul(x2, x2)
            return F.mul(F.mul(x4, x2), x)

        def sbox_all(xs):
            """x^7 on every element via stacked multiplies (4 ext
            products on `stark.ExtOps` instead of 48)."""
            x2 = F.mul_elems(xs, xs)
            x4 = F.mul_elems(x2, x2)
            x6 = F.mul_elems(x4, x2)
            return F.mul_elems(x6, xs)

        def constant_layer(st, rnd):
            return [F.add(s, F.from_base(rc[rnd * 12 + i]))
                    for i, s in enumerate(st)]

        def mds(st):
            new = []
            for r in range(12):
                acc = _mul_const(F, mds_rows[r][0], st[0])
                for c in range(1, 12):
                    acc = F.add(acc, _mul_const(F, mds_rows[r][c], st[c]))
                new.append(acc)
            return new

        swap = wires[self.WIRE_SWAP]
        out.append(F.mul(swap, F.sub(swap, one)))
        ins = [wires[self.wire_input(i)] for i in range(12)]
        deltas = [wires[self.wire_delta(i)] for i in range(4)]
        for i in range(4):
            out.append(F.sub(F.mul(swap, F.sub(ins[i + 4], ins[i])),
                             deltas[i]))
        state = list(ins)
        for i in range(4):
            state[i] = F.add(ins[i], deltas[i])
            state[i + 4] = F.sub(ins[i + 4], deltas[i])

        # round loops run through F.fold.  Each full round re-witnesses the
        # state, so the body is uniform: compare to wires, then transform
        # the wires.
        fold = F.fold

        def full_round_body(state, x):
            ws, rcs = x
            ys = tuple(F.sub(state[i], ws[i]) for i in range(12))
            st = [F.add(ws[i], rcs[i]) for i in range(12)]
            st = mds(sbox_all(st))
            return st, ys

        def partial_round_body(state, x):
            w, rcs = x
            st = [F.add(state[i], rcs[i]) for i in range(12)]
            y = F.sub(st[0], w)
            st[0] = sbox(w)
            return mds(st), (y,)

        def rc_f(rnd):
            return tuple(F.from_base(rc[rnd * 12 + i]) for i in range(12))

        # round 0 reads the swapped inputs directly (no witness compare)
        state = constant_layer(state, 0)
        state = mds(sbox_all(state))

        xs = [(tuple(wires[self.wire_full_first(r, i)] for i in range(12)),
               rc_f(r)) for r in range(1, 4)]
        state, ys = fold(full_round_body, state, xs)
        out.extend(c for y in ys for c in y)

        xs = [(wires[self.wire_partial(r)], rc_f(4 + r)) for r in range(22)]
        state, ys = fold(partial_round_body, state, xs)
        out.extend(c for y in ys for c in y)

        xs = [(tuple(wires[self.wire_full_second(r, i)] for i in range(12)),
               rc_f(26 + r)) for r in range(4)]
        state, ys = fold(full_round_body, state, xs)
        out.extend(c for y in ys for c in y)

        for i in range(12):
            out.append(F.sub(state[i], wires[self.wire_output(i)]))
        return out


# ----------------------------------------------------------------------------
# Extension-algebra helpers: a degree-2 Goldilocks extension element whose
# coordinates are F values (plonky2 ExtensionAlgebra — the verifier runs F
# itself over the extension at zeta, so these are "extension of extension").
# W = 7 (ops/goldilocks_ext.py W; x^2 - 7 irreducible over Goldilocks).
# ----------------------------------------------------------------------------

_EXT_W = 7


def _alg_mul(F, a, b):
    w = F.from_base(_EXT_W)
    return (F.add(F.mul(a[0], b[0]), F.mul(w, F.mul(a[1], b[1]))),
            F.add(F.mul(a[0], b[1]), F.mul(a[1], b[0])))


def _alg_scalar_mul(F, s, a):
    return (F.mul(s, a[0]), F.mul(s, a[1]))


def _alg_add(F, a, b):
    return (F.add(a[0], b[0]), F.add(a[1], b[1]))


def _alg_sub(F, a, b):
    return (F.sub(a[0], b[0]), F.sub(a[1], b[1]))


class ArithmeticExtensionGate(Gate):
    """num_ops independent EXTENSION-field ops sharing row constants c0, c1:
    out = c0 * m0 * m1 + c1 * addend, where each operand is a degree-2
    extension element spread over 2 consecutive routed wires (plonky2
    gates/arithmetic_extension.rs).  Wires per op:
    [m0.0, m0.1, m1.0, m1.1, addend.0, addend.1, out.0, out.1]."""

    def __init__(self, num_ops):
        self.num_ops = num_ops
        self.num_wires = 8 * num_ops
        self.num_constants = 2

    def id(self):
        return f"ArithmeticExtensionGate(num_ops={self.num_ops})"

    def degree(self):
        return 3

    def num_constraints(self):
        return 2 * self.num_ops

    @staticmethod
    def wires_ith_op(i):
        return tuple(range(8 * i, 8 * i + 8))

    def eval(self, F, constants, wires, public_inputs_hash):
        c0, c1 = constants[0], constants[1]
        xs = [tuple(wires[w] for w in self.wires_ith_op(i))
              for i in range(self.num_ops)]

        def body(carry, op):
            m0 = (op[0], op[1])
            m1 = (op[2], op[3])
            addend = (op[4], op[5])
            o = (op[6], op[7])
            computed = _alg_add(F,
                                _alg_scalar_mul(F, c0, _alg_mul(F, m0, m1)),
                                _alg_scalar_mul(F, c1, addend))
            d = _alg_sub(F, computed, o)
            return carry, (d[0], d[1])

        _, ds = F.fold(body, F.zero(), xs)    # one scan over the ops
        return [x for d in ds for x in d]


class MulExtensionGate(Gate):
    """num_ops extension multiplies sharing one row constant:
    out = c0 * m0 * m1 (plonky2 gates/multiplication_extension.rs).
    Wires per op: [m0.0, m0.1, m1.0, m1.1, out.0, out.1]."""

    def __init__(self, num_ops):
        self.num_ops = num_ops
        self.num_wires = 6 * num_ops
        self.num_constants = 1

    def id(self):
        return f"MulExtensionGate(num_ops={self.num_ops})"

    def degree(self):
        return 3

    def num_constraints(self):
        return 2 * self.num_ops

    @staticmethod
    def wires_ith_op(i):
        return tuple(range(6 * i, 6 * i + 6))

    def eval(self, F, constants, wires, public_inputs_hash):
        c0 = constants[0]
        xs = [tuple(wires[w] for w in self.wires_ith_op(i))
              for i in range(self.num_ops)]

        def body(carry, op):
            m0 = (op[0], op[1])
            m1 = (op[2], op[3])
            o = (op[4], op[5])
            computed = _alg_scalar_mul(F, c0, _alg_mul(F, m0, m1))
            d = _alg_sub(F, computed, o)
            return carry, (d[0], d[1])

        _, ds = F.fold(body, F.zero(), xs)    # one scan over the ops
        return [x for d in ds for x in d]


class RandomAccessGate(Gate):
    """Random access into a length-2^bits vector (plonky2
    gates/random_access.rs): each copy checks
        claimed == vec[access_index]
    via a binary select tree over the index's bits.  Routed wires per copy:
    [access_index, claimed, item_0, ..., item_{2^bits - 1}]; the index bits
    are unrouted intermediate wires after all copies' routed blocks.
    Constraints per copy: booleanity of each bit (degree 2), the bit
    recomposition equals access_index (degree 1), and the select-tree result
    equals claimed (degree bits + 1)."""

    def __init__(self, bits, num_copies=1):
        self.bits = bits
        self.vec_size = 1 << bits
        self.num_copies = num_copies
        self._routed = num_copies * (2 + self.vec_size)
        self.num_wires = self._routed + num_copies * bits
        self.num_constants = 0

    def id(self):
        return f"RandomAccessGate(bits={self.bits}, num_copies={self.num_copies})"

    def degree(self):
        return max(2, self.bits + 1)

    def num_constraints(self):
        return self.num_copies * (self.bits + 2)

    def wire_index(self, c):
        return c * (2 + self.vec_size)

    def wire_claimed(self, c):
        return c * (2 + self.vec_size) + 1

    def wire_item(self, c, i):
        return c * (2 + self.vec_size) + 2 + i

    def wire_bit(self, c, j):
        return self._routed + c * self.bits + j

    def eval(self, F, constants, wires, public_inputs_hash):
        one = F.one()
        out = []
        for c in range(self.num_copies):
            bits = [wires[self.wire_bit(c, j)] for j in range(self.bits)]
            for b in bits:
                out.append(F.mul(b, F.sub(b, one)))
            acc = F.zero()
            for b in reversed(bits):
                acc = F.add(F.add(acc, acc), b)
            out.append(F.sub(acc, wires[self.wire_index(c)]))
            lst = [wires[self.wire_item(c, i)] for i in range(self.vec_size)]
            for b in bits:              # LSB-first halving select tree
                lst = [F.add(lst[2 * i],
                             F.mul(b, F.sub(lst[2 * i + 1], lst[2 * i])))
                       for i in range(len(lst) // 2)]
            out.append(F.sub(lst[0], wires[self.wire_claimed(c)]))
        return out


def _alg_from_base_wire(F, w):
    """Embed a base-field wire value as the algebra element (w, 0)."""
    return (w, F.zero())


class LookupGate(Gate):
    """Lookup slots: `num_slots` routed (input, output) wire pairs that must
    appear (as pairs) in lookup table `lut_index` — plonky2 gates/lookup.rs
    in role and wire layout.  The gate itself carries NO constraints: the
    logUp lookup-argument terms (vanishing.py `lookup_terms`, gated by the
    preprocessed boolean lookup-selector columns) bind its wires.  The
    table itself is `common.LutMeta.table`."""

    def __init__(self, num_slots, lut_index):
        self.num_slots = num_slots
        self.lut_index = lut_index
        self.num_wires = 2 * num_slots

    def id(self):
        return (f"LookupGate(num_slots={self.num_slots},"
                f"lut={self.lut_index})")

    def degree(self):
        return 0                       # no gate-stream constraints

    @staticmethod
    def wire_inp(s):
        return 2 * s

    @staticmethod
    def wire_out(s):
        return 2 * s + 1


class LookupTableGate(Gate):
    """One row of lookup table `lut_index`: `num_slots` (input, output)
    entries as per-row gate CONSTANTS (columns 2s, 2s+1 — preprocessed, so
    the table contents are circuit-fixed) plus `num_slots` prover-set
    multiplicity wires (columns s) — plonky2 gates/lookup_table.rs in role.
    Padding slots repeat the last table entry with multiplicity 0.  Like
    LookupGate, all constraints live in the logUp terms."""

    def __init__(self, num_slots, lut_index):
        self.num_slots = num_slots
        self.lut_index = lut_index
        self.num_wires = num_slots
        self.num_constants = 2 * num_slots

    def id(self):
        return (f"LookupTableGate(num_slots={self.num_slots},"
                f"lut={self.lut_index})")

    def degree(self):
        return 0

    @staticmethod
    def wire_mult(s):
        return s


class ReducingGate(Gate):
    """One Horner step batch over BASE-field coefficients (plonky2
    gates/reducing.rs): acc_{i} = acc_{i-1} * alpha + coeff_i, where alpha
    and the accumulators are extension-algebra elements and the coeffs are
    single base wires (part of the gate mix of plonky2's recursive verifier
    circuit).

    Wires: output (0..2), alpha (2..4), old_acc (4..6),
    coeffs (6..6+num_coeffs, routed base wires), intermediate accumulators
    (unrouted, 2 wires each for the first num_coeffs-1 steps)."""

    def __init__(self, num_coeffs):
        assert num_coeffs >= 1
        self.num_coeffs = num_coeffs
        self.num_wires = 6 + num_coeffs + 2 * (num_coeffs - 1)
        self.num_constants = 0

    def id(self):
        return f"ReducingGate(num_coeffs={self.num_coeffs})"

    def degree(self):
        return 2

    def num_constraints(self):
        return 2 * self.num_coeffs

    @staticmethod
    def wires_output():
        return (0, 1)

    @staticmethod
    def wires_alpha():
        return (2, 3)

    @staticmethod
    def wires_old_acc():
        return (4, 5)

    def wire_coeff(self, i):
        return 6 + i

    def wires_acc(self, i):
        assert i < self.num_coeffs - 1
        s = 6 + self.num_coeffs + 2 * i
        return (s, s + 1)

    def _acc_pairs(self, wires):
        """The chained accumulator targets: intermediates then the output."""
        return ([tuple(wires[w] for w in self.wires_acc(i))
                 for i in range(self.num_coeffs - 1)]
                + [tuple(wires[w] for w in self.wires_output())])

    def eval(self, F, constants, wires, public_inputs_hash):
        alpha = tuple(wires[w] for w in self.wires_alpha())
        acc = tuple(wires[w] for w in self.wires_old_acc())
        out = []
        for i, nxt in enumerate(self._acc_pairs(wires)):
            coeff = _alg_from_base_wire(F, wires[self.wire_coeff(i)])
            computed = _alg_add(F, _alg_mul(F, acc, alpha), coeff)
            d = _alg_sub(F, computed, nxt)
            out.extend([d[0], d[1]])
            acc = nxt
        return out


class ReducingExtensionGate(Gate):
    """ReducingGate over EXTENSION coefficients (plonky2
    gates/reducing_extension.rs): acc_i = acc_{i-1} * alpha + coeff_i with
    each coeff spread over 2 routed wires.

    Wires: output (0..2), alpha (2..4), old_acc (4..6),
    coeff_i (6+2i..8+2i, routed), intermediate accumulators (unrouted)."""

    def __init__(self, num_coeffs):
        assert num_coeffs >= 1
        self.num_coeffs = num_coeffs
        self.num_wires = 6 + 2 * num_coeffs + 2 * (num_coeffs - 1)
        self.num_constants = 0

    def id(self):
        return f"ReducingExtensionGate(num_coeffs={self.num_coeffs})"

    def degree(self):
        return 2

    def num_constraints(self):
        return 2 * self.num_coeffs

    wires_output = staticmethod(ReducingGate.wires_output)
    wires_alpha = staticmethod(ReducingGate.wires_alpha)
    wires_old_acc = staticmethod(ReducingGate.wires_old_acc)

    def wires_coeff(self, i):
        return (6 + 2 * i, 7 + 2 * i)

    def wires_acc(self, i):
        assert i < self.num_coeffs - 1
        s = 6 + 2 * self.num_coeffs + 2 * i
        return (s, s + 1)

    def _acc_pairs(self, wires):
        return ([tuple(wires[w] for w in self.wires_acc(i))
                 for i in range(self.num_coeffs - 1)]
                + [tuple(wires[w] for w in self.wires_output())])

    def eval(self, F, constants, wires, public_inputs_hash):
        alpha = tuple(wires[w] for w in self.wires_alpha())
        acc = tuple(wires[w] for w in self.wires_old_acc())
        out = []
        for i, nxt in enumerate(self._acc_pairs(wires)):
            coeff = tuple(wires[w] for w in self.wires_coeff(i))
            computed = _alg_add(F, _alg_mul(F, acc, alpha), coeff)
            d = _alg_sub(F, computed, nxt)
            out.extend([d[0], d[1]])
            acc = nxt
        return out


class PoseidonMdsGate(Gate):
    """The Poseidon 12x12 MDS matrix applied to a state of 12 EXTENSION
    elements (plonky2 gates/poseidon_mds.rs): out_r = sum_i circ[i] *
    in[(i+r)%12] + diag[r] * in[r].  All 48 wires routed.  Linear in the
    wires; degree declared 2 for plonky2 selector-grouping parity."""

    num_wires = 48
    num_constants = 0

    def degree(self):
        return 2

    def num_constraints(self):
        return 24

    @staticmethod
    def wires_input(i):
        return (2 * i, 2 * i + 1)

    @staticmethod
    def wires_output(i):
        return (24 + 2 * i, 25 + 2 * i)

    @staticmethod
    def _mds_tables():
        return MDS_MATRIX_CIRC, MDS_MATRIX_DIAG

    def eval(self, F, constants, wires, public_inputs_hash):
        circ, diag = self._mds_tables()
        ins = [tuple(wires[w] for w in self.wires_input(i)) for i in range(12)]
        # fold over output rows: the circulant constants are shared by every
        # row (host-int mul_const_small inside the body), the rotation is
        # pure reindexing in the stacked xs, and only diag[r] needs a traced
        # per-row value (ONE scan instead of 312 unrolled const-multiplies)
        xs = []
        for r in range(12):
            rot = tuple(ins[(i + r) % 12] for i in range(12))
            o = tuple(wires[w] for w in self.wires_output(r))
            xs.append((rot, F.from_base(diag[r]), ins[r], o))

        def body(carry, x):
            rot, dg, inr, o = x
            acc0 = _mul_const(F, circ[0], rot[0][0])
            acc1 = _mul_const(F, circ[0], rot[0][1])
            for i in range(1, 12):
                acc0 = F.add(acc0, _mul_const(F, circ[i], rot[i][0]))
                acc1 = F.add(acc1, _mul_const(F, circ[i], rot[i][1]))
            acc0 = F.add(acc0, F.mul(dg, inr[0]))
            acc1 = F.add(acc1, F.mul(dg, inr[1]))
            return carry, (F.sub(acc0, o[0]), F.sub(acc1, o[1]))

        _, ys = F.fold(body, F.zero(), xs)
        return [c for y in ys for c in y]


class CosetInterpolationGate(Gate):
    """Interpolate values on the coset shift*H (H the size-2^subgroup_bits
    two-adic subgroup) and evaluate at an extension point (plonky2
    gates/coset_interpolation.rs) — the gate plonky2's recursive FRI
    verifier uses for the arity fold.

    The interpolated evaluation is the division-free barycentric form
        L(x) = sum_i w_i * v_i * prod_{j != i} (x - x_j),
    with barycentric weights w_i = g^i / n for the subgroup domain, built
    incrementally: eval' = (x - x_i) * eval + w_i * v_i * prod,
    prod' = (x - x_i) * prod.  The coset shift is handled by substitution:
    a witnessed shifted point sx with sx * shift == x is interpolated
    against the UNSHIFTED domain.  The running (eval, prod) pair is
    re-witnessed every `degree - 1` points (after an initial chunk of
    `degree` points) to bound the constraint degree.

    Wires: shift (0, routed base), values (1 + 2i, routed ext), evaluation
    point (routed ext), evaluation value (routed ext), then unrouted
    intermediates: num_intermediates eval pairs, num_intermediates prod
    pairs, and the shifted evaluation point."""

    def __init__(self, subgroup_bits, max_degree=6):
        assert max_degree >= 2
        self.subgroup_bits = subgroup_bits
        self.num_points = 1 << subgroup_bits
        self.max_degree = min(max_degree, self.num_points)
        self.num_intermediates = max(
            0, (self.num_points - 2) // (self.max_degree - 1))
        self._start_intermediates = 1 + 2 * (self.num_points + 2)
        self.num_wires = (self._start_intermediates
                          + 4 * self.num_intermediates + 2)
        self.num_constants = 0

    def id(self):
        return (f"CosetInterpolationGate(subgroup_bits={self.subgroup_bits},"
                f" degree={self.max_degree})")

    def degree(self):
        return self.max_degree

    def num_constraints(self):
        return 2 + 2 * (2 * self.num_intermediates + 1)

    wire_shift = 0

    def wires_value(self, i):
        return (1 + 2 * i, 2 + 2 * i)

    def wires_evaluation_point(self):
        s = 1 + 2 * self.num_points
        return (s, s + 1)

    def wires_evaluation_value(self):
        s = 3 + 2 * self.num_points
        return (s, s + 1)

    @property
    def num_routed(self):
        return self._start_intermediates

    def wires_intermediate_eval(self, i):
        s = self._start_intermediates + 2 * i
        return (s, s + 1)

    def wires_intermediate_prod(self, i):
        s = self._start_intermediates + 2 * (self.num_intermediates + i)
        return (s, s + 1)

    def wires_shifted_evaluation_point(self):
        s = self._start_intermediates + 4 * self.num_intermediates
        return (s, s + 1)

    def _domain_and_weights(self):
        n = self.num_points
        g = gl.primitive_root_of_unity(self.subgroup_bits)
        domain = [pow(g, i, gl.P) for i in range(n)]
        n_inv = gl.batch_inv_host([n])[0]
        weights = [x * n_inv % gl.P for x in domain]   # w_i = g^i / n
        return domain, weights

    def _chunks(self):
        """[(start, end)] point ranges: `degree` points, then `degree - 1`."""
        d = self.max_degree
        out = [(0, min(d, self.num_points))]
        for i in range(self.num_intermediates):
            start = 1 + (d - 1) * (i + 1)
            out.append((start, min(start + d - 1, self.num_points)))
        return out

    def eval(self, F, constants, wires, public_inputs_hash):
        domain, weights = self._domain_and_weights()
        shift = wires[self.wire_shift]
        x = tuple(wires[w] for w in self.wires_evaluation_point())
        sx = tuple(wires[w] for w in self.wires_shifted_evaluation_point())
        out = []
        d = _alg_sub(F, _alg_scalar_mul(F, shift, sx), x)
        out.extend([d[0], d[1]])

        values = [tuple(wires[w] for w in self.wires_value(i))
                  for i in range(self.num_points)]

        def step(carry, x):
            ev, pr = carry
            dom, wt, val = x
            x_m_xi = (F.sub(sx[0], dom), sx[1])
            wv = _alg_scalar_mul(F, wt, val)
            ev_next = _alg_add(F, _alg_mul(F, x_m_xi, ev),
                               _alg_mul(F, wv, pr))
            pr_next = _alg_mul(F, x_m_xi, pr)
            return (ev_next, pr_next), ()

        def partial(lo, hi, ev, pr):
            xs = [(F.from_base(domain[i]), F.from_base(weights[i]), values[i])
                  for i in range(lo, hi)]
            (ev, pr), _ = F.fold(step, (ev, pr), xs)
            return ev, pr

        chunks = self._chunks()
        ev = (F.zero(), F.zero())
        pr = (F.one(), F.zero())
        ev, pr = partial(*chunks[0], ev, pr)
        for i in range(self.num_intermediates):
            w_ev = tuple(wires[w] for w in self.wires_intermediate_eval(i))
            w_pr = tuple(wires[w] for w in self.wires_intermediate_prod(i))
            de = _alg_sub(F, w_ev, ev)
            dp = _alg_sub(F, w_pr, pr)
            out.extend([de[0], de[1], dp[0], dp[1]])
            ev, pr = partial(*chunks[i + 1], w_ev, w_pr)
        val = tuple(wires[w] for w in self.wires_evaluation_value())
        dv = _alg_sub(F, val, ev)
        out.extend([dv[0], dv[1]])
        return out


# ----------------------------------------------------------------------------
# Selectors (plonky2 gates/selectors.rs)
# ----------------------------------------------------------------------------

def compute_selector_groups(gates, max_degree):
    """Group the circuit's gate list (in index order) into contiguous selector
    groups such that gate.degree + |group| - 1 <= max_degree.  Returns a list
    of (start, end) ranges."""
    groups = []
    start = 0
    for i, g in enumerate(gates):
        size = i - start + 1
        worst = max(gates[j].degree() for j in range(start, i + 1))
        if worst + size - 1 > max_degree:
            groups.append((start, i))
            start = i
    groups.append((start, len(gates)))
    return groups


def compute_filter(F, gate_index, group, s, many_groups):
    """prod_{k in group, k != gate_index} (k - s) [* (UNUSED - s)]."""
    acc = F.one()
    for k in range(group[0], group[1]):
        if k == gate_index:
            continue
        acc = F.mul(acc, F.sub(F.from_base(k), s))
    if many_groups:
        acc = F.mul(acc, F.sub(F.from_base(UNUSED_SELECTOR), s))
    return acc


def evaluate_gate_constraints(F, gates, selector_groups,
                              constants, wires, public_inputs_hash,
                              num_gate_constraints, num_selectors):
    """Sum of filtered per-gate constraints, padded to num_gate_constraints
    (plonky2 plonk_common::evaluate_gate_constraints): term[j] +=
    filter_i * constraint_{i,j} over every gate type i in the circuit."""
    many = num_selectors > 1
    terms = [F.zero() for _ in range(num_gate_constraints)]
    for gi, gate in enumerate(gates):
        group_idx = next(si for si, (a, b) in enumerate(selector_groups)
                         if a <= gi < b)
        s = constants[group_idx]
        filt = compute_filter(F, gi, selector_groups[group_idx], s, many)
        gate_constants = constants[num_selectors:]
        cs = gate.eval(F, gate_constants, wires, public_inputs_hash)
        assert len(cs) <= num_gate_constraints
        # filter-multiply all constraints at once (one stacked ext product
        # on `stark.ExtOps` instead of len(cs))
        for j, c in enumerate(F.mul_many(filt, cs)):
            terms[j] = F.add(terms[j], c)
    return terms


# ----------------------------------------------------------------------------
# Rebuilding a circuit's gates from a fixture
# ----------------------------------------------------------------------------

# class name -> the attributes its constructor takes, in order
GATE_PARAMS = {
    "NoopGate": (),
    "ConstantGate": ("num_consts",),
    "ArithmeticGate": ("num_ops",),
    "PublicInputGate": (),
    "BaseSumGate": ("num_limbs", "base"),
    "ExponentiationGate": ("num_power_bits",),
    "PoseidonGate": (),
    "ArithmeticExtensionGate": ("num_ops",),
    "MulExtensionGate": ("num_ops",),
    "RandomAccessGate": ("bits", "num_copies"),
    "LookupGate": ("num_slots", "lut_index"),
    "LookupTableGate": ("num_slots", "lut_index"),
    "ReducingGate": ("num_coeffs",),
    "ReducingExtensionGate": ("num_coeffs",),
    "PoseidonMdsGate": (),
    "CosetInterpolationGate": ("subgroup_bits", "max_degree"),
}
_GATES = {cls.__name__: cls for cls in Gate.__subclasses__()}
assert set(_GATES) == set(GATE_PARAMS)


def gate_to_json(gate):
    """{"id", "class", "params"} of a gate object (any object with this
    module's class names and attributes)."""
    name = type(gate).__name__
    return {"id": gate.id(), "class": name,
            "params": {k: getattr(gate, k) for k in GATE_PARAMS[name]}}


def gate_from_json(d):
    """The gate a fixture entry names; raises ValueError on an unknown class,
    a wrong parameter set or an id that the rebuilt gate does not give."""
    name = d["class"]
    if name not in _GATES:
        raise ValueError(f"unknown gate class {name!r}")
    params = d["params"]
    if set(params) != set(GATE_PARAMS[name]):
        raise ValueError(f"{name}: parameters {sorted(params)}, expected "
                         f"{sorted(GATE_PARAMS[name])}")
    gate = _GATES[name](*(int(params[k]) for k in GATE_PARAMS[name]))
    if gate.id() != d["id"]:
        raise ValueError(f"gate rebuilt as {gate.id()!r}, fixture says "
                         f"{d['id']!r}")
    return gate

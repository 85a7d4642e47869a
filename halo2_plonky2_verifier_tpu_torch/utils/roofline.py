"""The least time an NVIDIA H100 SXM could take for a kernel's work.

`bound` is the larger of the bytes a kernel must move (inputs read once,
outputs written once) over the card's 3.35 TB/s, and its operations over the
card's peak rate for their type: 132 SMs x 64 32-bit IMAD per clock
(compute capability 9.0) x 1.98 GHz boost for integer multiplies, 132 SMs x
128 FP32 lanes per clock x 1.98 GHz (67 TFLOP/s counting an FMA as two) for
f32 multiplies.  An IMAD.WIDE.U32 (a 32 x 32 -> 64-bit product with a
64-bit addend, what the BN254 body's products are made of) counts as one
of the 64; `tools/torch_bn254_micro.py`'s wide_mul16 probe measures the
rate the card gives for it, which these published peaks do not change.

A multiply is one 32 x 32 -> 64-bit partial product of the schoolbook
method on 32-bit words (a square of n words takes n(n+1)/2), and each
permutation is counted in its cheapest known form, whatever form a kernel
computes:
  Goldilocks (2 words): product 4, square 3, an element times a small MDS
  constant 2; S-box x^7 = 2 squares + 2 products.  plonky2's schedule with
  the fast partial layer: 8 full rounds of 12 S-boxes and the circulant
  MDS (145 small products); the partial layer's initial 11 x 11 matrix
  once; 22 partial rounds of one S-box, 22 products (w_hat and v rows) and
  one small product (mds_partial_layer_fast).
  BN254 (8 words): product 64, square 36, Montgomery reduction (REDC)
  8 * (1 + 8) = 72; S-box x^5 = 2 squares + 1 product, each reduced.  The
  optimized schedule of refimpl/poseidon_bn254_opt.py: 8 full rounds of 4
  S-boxes and a dense mix (4 rows of 4 products and one REDC); 56 partial
  rounds of one S-box and a sparse mix (row 0: 4 products, one REDC;
  rows 1-3: one product and one REDC each).

K10's work (`gl_mul_chain`) is `chain` Goldilocks products an element.

Used by `chip_smoke.py`, `tools/torch_sol_bench.py` and
`tools/torch_bn254_micro.py`.
"""

HBM_BYTES_PER_S = 3.35e12
SMS, BOOST_HZ = 132, 1.98e9
IMAD_PER_CLOCK_SM, F32_MUL_PER_CLOCK_SM = 64, 128
IMAD_PER_S = SMS * IMAD_PER_CLOCK_SM * BOOST_HZ
F32_MUL_PER_S = SMS * F32_MUL_PER_CLOCK_SM * BOOST_HZ

GL_MUL, GL_SQR, GL_SMALL = 4, 3, 2
GL_SBOX = 2 * GL_SQR + 2 * GL_MUL
GL_PERM_MULS = (8 * (12 * GL_SBOX + 145 * GL_SMALL) + 11 * 11 * GL_MUL
                + 22 * (GL_SBOX + 22 * GL_MUL + GL_SMALL))          # 6,436

BN_MUL, BN_SQR, BN_REDC = 64, 36, 72
BN_MONT_MUL = BN_MUL + BN_REDC
BN_SBOX = 2 * (BN_SQR + BN_REDC) + BN_MONT_MUL
BN_MIX = 4 * (4 * BN_MUL + BN_REDC)           # the dense mix, one REDC a row
BN_FULL_ROUND = 4 * BN_SBOX + BN_MIX
BN_PARTIAL_ROUND = BN_SBOX + 7 * BN_MUL + 4 * BN_REDC
BN_PERM_MULS = 8 * BN_FULL_ROUND + 56 * BN_PARTIAL_ROUND             # 82,688


def gl_mul_chain(lanes, chain):
    """(bytes, operations) of K10: `chain` products on each of `lanes`
    elements, x and y read once and the result written once."""
    return 3 * 8 * lanes, lanes * chain * GL_MUL


def bound(nbytes, ops, ops_per_s=IMAD_PER_S):
    """(bound_ms, bound_by) for a kernel moving `nbytes` and doing `ops`
    operations at `ops_per_s` at best; bound_by is "bytes" or
    "operations"."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")

"""The work a batch's Merkle checks need, and the least time an H100 could
take for it: the numerator of `merkle_roofline`.

Counted from the proof geometry, whatever kernel does the work and however
it pads: each query walks every initial oracle's path (the initial depth)
and every FRI step's path (that step's depth), one compression a level; a
leaf wider than a hash's noop width (4 Goldilocks elements, or 3 packed in
one BN254 element) is absorbed by the sponge at rate 8 (Goldilocks) or 9
(BN254), one permutation a chunk.  At n = 2^5 under `standard_fast_config`
that is 84 x 3 x 2 = 504 compressions and no sponge.

The bytes are the leaves, siblings and caps, each read once.  Each
permutation counts in its cheapest known form; the peaks are NVIDIA's
published H100 SXM ones.  A frozen copy of the program's roofline
arithmetic (32-bit multiplies of the schoolbook method on 32-bit words):

  Goldilocks (2 words): product 4, square 3, times a small MDS constant 2;
  S-box x^7 = 2 squares + 2 products; plonky2's schedule with the fast
  partial layer: 8 full rounds of 12 S-boxes and the circulant MDS (145
  small products), the partial layer's 11 x 11 matrix once, 22 partial
  rounds of one S-box, 22 products and one small product: 6,436.
  BN254 (8 words): product 64, square 36, Montgomery reduction 72; S-box x^5
  = 2 reduced squares + 1 reduced product; 8 full rounds of 4 S-boxes and a
  dense mix (4 rows of 4 products, one reduction); 56 partial rounds of one
  S-box and a sparse mix (7 products, 4 reductions): 82,688.
"""

HBM_BYTES_PER_S = 3.35e12
SMS, BOOST_HZ, IMAD_PER_CLOCK_SM = 132, 1.98e9, 64
IMAD_PER_S = SMS * IMAD_PER_CLOCK_SM * BOOST_HZ

GL_MUL, GL_SQR, GL_SMALL = 4, 3, 2
GL_SBOX = 2 * GL_SQR + 2 * GL_MUL
GL_PERM_MULS = (8 * (12 * GL_SBOX + 145 * GL_SMALL) + 11 * 11 * GL_MUL
                + 22 * (GL_SBOX + 22 * GL_MUL + GL_SMALL))          # 6,436

BN_MUL, BN_SQR, BN_REDC = 64, 36, 72
BN_SBOX = 2 * (BN_SQR + BN_REDC) + BN_MUL + BN_REDC
BN_FULL_ROUND = 4 * BN_SBOX + 4 * (4 * BN_MUL + BN_REDC)
BN_PARTIAL_ROUND = BN_SBOX + 7 * BN_MUL + 4 * BN_REDC
BN_PERM_MULS = 8 * BN_FULL_ROUND + 56 * BN_PARTIAL_ROUND            # 82,688

# hasher -> (multiplies a permutation, noop width, sponge rate, hash bytes)
HASHERS = {"poseidon_goldilocks": (GL_PERM_MULS, 4, 8, 32),
           "poseidon_bn254": (BN_PERM_MULS, 3, 9, 32)}


def merkle_work(geom):
    """Per proof: {compressions, sponge_perms, permutations, bytes, ops}."""
    perm_muls, noop, rate, hash_bytes = HASHERS[geom.hasher]
    q = geom.num_queries
    depths = [geom.initial_depth] * len(geom.oracle_widths) + list(
        geom.step_depths)
    widths = list(geom.oracle_widths) + [
        2 << ab for ab in geom.reduction_arity_bits]
    compressions = q * sum(depths)
    sponge = q * sum(-(-w // rate) for w in widths if w > noop)
    trees = len(depths)
    nbytes = (q * sum(widths) * 8 + q * sum(depths) * hash_bytes
              + trees * geom.cap_size * hash_bytes)
    perms = compressions + sponge
    return {"compressions": compressions, "sponge_perms": sponge,
            "permutations": perms, "bytes": nbytes,
            "ops": perms * perm_muls}


def least_seconds(nbytes, ops):
    """The larger of the bytes over the HBM rate and the multiplies over the
    card's 32-bit multiply rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / IMAD_PER_S)

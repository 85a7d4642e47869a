"""The benchmark's proofs: columnar npz files of distinct starky proofs,
read with numpy alone into {field: uint64 array} with a leading lane axis.

An npz holds the leaves a0, a1, ... of the JAX package's proof batch in its
field order: a Goldilocks array as a (hi, lo) pair of uint32 arrays, a
Goldilocks hash array too, a BN254 hash array as one (..., 16) array of
16-bit limbs; a list field one entry after another (`commit_caps`,
`step_evals` and `step_siblings` one a FRI step, `initial_evals` and
`initial_siblings` one an oracle).  A BN254 hash comes out as its four
little-endian u64 words, as the program takes it.
"""

import numpy as np

FIELDS = ("trace_cap", "zs_cap", "quotient_cap", "local_values",
          "next_values", "permutation_zs", "permutation_zs_next",
          "quotient_polys", "commit_caps", "final_poly", "pow_witness",
          "initial_evals", "initial_siblings", "step_evals", "step_siblings",
          "public_inputs")
HASH_FIELDS = ("trace_cap", "zs_cap", "quotient_cap", "commit_caps",
               "initial_siblings", "step_siblings")


def _hi_lo(hi, lo):
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _bn254_words(limbs):
    q = limbs.astype(np.uint64).reshape(limbs.shape[:-1] + (4, 4))
    return (q[..., 0] | (q[..., 1] << np.uint64(16))
            | (q[..., 2] << np.uint64(32)) | (q[..., 3] << np.uint64(48)))


def load(path, geom):
    """{field: uint64 array, or a list of them} of every proof in `path`.
    Raises ValueError when the arrays do not have `geom`'s shapes."""
    with np.load(path) as data:
        leaves = [data[f"a{i}"] for i in range(len(data.files))]
    shapes = geom.field_shapes()
    pos = 0
    out = {}
    for name in FIELDS:
        bn = name in HASH_FIELDS and geom.hasher == "poseidon_bn254"
        arrays = []
        for _ in (shapes[name] if isinstance(shapes[name], list) else [0]):
            if bn:
                arrays.append(_bn254_words(leaves[pos]))
                pos += 1
            else:
                arrays.append(_hi_lo(leaves[pos], leaves[pos + 1]))
                pos += 2
        out[name] = arrays if isinstance(shapes[name], list) else arrays[0]
    if pos != len(leaves):
        raise ValueError(f"{path}: {len(leaves) - pos} arrays left over")
    lanes = len(out["pow_witness"])
    for name, want in shapes.items():
        got = ([a.shape for a in out[name]] if isinstance(want, list)
               else out[name].shape)
        want = ([(lanes,) + w for w in want] if isinstance(want, list)
                else (lanes,) + want)
        if got != want:
            raise ValueError(f"{path}: {name} has shape {got}, not {want}")
    return out


def select(fields, lanes):
    """The proofs at `lanes` (an index array), as new arrays."""
    return {k: ([a[lanes] for a in v] if isinstance(v, list) else v[lanes])
            for k, v in fields.items()}

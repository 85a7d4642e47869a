"""The Poseidon-Goldilocks hash backend of the verifier (HasherChip analog).

A hash is a (..., 4) int64 tensor of Goldilocks elements.  Counterpart of
`GLHashOps` and `_take_cap_raw` in `halo2_plonky2_verifier_tpu/hashing.py`;
the BN254 backend belongs to a later slice of the port.
"""

import torch


def take_cap(caps, cap_index):
    """caps (B, S, cap, 4), cap_index (B, Q) -> (B, Q, S, 4): the cap entry
    each query's path must reach (select_from_idx over the Merkle cap).
    A gather, where the JAX package takes a one-hot mask-sum; the results
    agree for every index below the cap size, which the verifier's top-bit
    cap index always is."""
    b = caps.shape[0]
    rows = torch.arange(b, device=caps.device)[:, None]
    return caps[rows, :, cap_index]


class GLHashOps:
    name = "poseidon_goldilocks"

    take_cap = staticmethod(take_cap)

    @staticmethod
    def eq(a, b):
        return (a == b).all(dim=-1)

    @staticmethod
    def stack(hashes, dim):
        return torch.stack(hashes, dim=dim)


def get_hash_ops(name):
    if name == "poseidon_goldilocks":
        return GLHashOps
    raise NotImplementedError(
        f"hasher {name!r} is not ported yet (only poseidon_goldilocks)")

"""Multi-process runtime: one rank per process, 1 card -> N ranks.

The counterpart of `halo2_plonky2_verifier_tpu/parallel/distributed.py`, on
torch.distributed:

 1. `initialize(...)`: the process group (no-op when it exists).  Nothing
    tells a program of a cluster, so the caller gives `init_method`
    (`tcp://host:port` or `file://path`), `world_size` and `rank`, or sets
    torch.distributed's environment (`MASTER_ADDR`, `WORLD_SIZE`, `RANK`).
 2. `local_batch_slice` and `global_batch`: each rank loads only the
    proofs of its dp slice; no proof bytes cross ranks, so `global_batch`
    is the identity on that local batch.
 3. `distributed_verifier(...)`: `mesh.sharded_verifier` on a rank's local
    batch, which takes the rank's query slice itself; `local_verdict` is
    the rank's verdict as numpy and `global_verdict` the whole batch's,
    gathered over dp.
"""

import os

import torch
import torch.distributed as dist

from ..utils.logging import get_logger
from .mesh import make_mesh, query_slice, sharded_verifier, slice_batch


def default_backend(world_size):
    """NCCL when every rank has a card of its own on this host, gloo
    otherwise: on the CPU, and for several ranks sharing one card, which
    NCCL refuses."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def initialize(init_method=None, world_size=None, rank=None, backend=None):
    """Join the process group (a no-op when the default group exists).
    Under NCCL, rank r (or torchrun's LOCAL_RANK) takes card r.  A failure
    raises: nothing falls back to another backend."""
    if dist.is_initialized():
        return
    kwargs = {}
    if world_size is not None:
        kwargs.update(world_size=world_size, rank=rank)
    backend = backend or default_backend(
        world_size if world_size is not None
        else int(os.environ.get("WORLD_SIZE", "1")))
    if backend == "nccl":
        local = (rank if rank is not None
                 else int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kwargs)
    get_logger(__name__).info(
        "distributed: rank %d/%d, backend %s", dist.get_rank(),
        dist.get_world_size(), backend)


def global_mesh(dp=None, qp=None):
    """The dp x qp split of every rank of the world (`make_mesh`)."""
    return make_mesh(dp=dp, qp=qp)


def local_batch_slice(global_batch_size, mesh):
    """(start, size) of this rank's slice of the proof batch axis: its dp
    slice, the same for every rank of one qp group."""
    if global_batch_size % mesh.dp:
        raise ValueError(f"{global_batch_size} proofs do not split into "
                         f"{mesh.dp} dp shards")
    per = global_batch_size // mesh.dp
    return mesh.dp_index * per, per


def global_batch(local_batch, mesh):
    """The batch a rank verifies is the one it loaded: each rank holds its
    own dp slice, so no proof bytes cross ranks."""
    return local_batch


def distributed_verifier(stark, config, degree_bits, mesh):
    """verify(local_batch) for a rank's dp slice with every query round
    (as `local_batch_slice` loads it): the rank's query slice through
    `sharded_verifier`, the verdict AND-reduced over its qp group."""
    verify = sharded_verifier(stark, config, degree_bits, mesh)

    def run(local_batch):
        return verify(slice_batch(
            local_batch, queries=query_slice(local_batch.shape.num_queries,
                                             mesh)))

    return run


def local_verdict(verdict):
    """This rank's (B / dp,) verdict as host numpy."""
    return verdict.cpu().numpy()


def global_verdict(verdict, mesh):
    """The whole (B,) verdict, in proof order, as host numpy: this rank's
    slice gathered over its dp group."""
    if mesh.dp_group is None:
        return local_verdict(verdict)
    v = verdict.to(torch.int32)
    if dist.get_backend(mesh.dp_group) != "nccl":
        v = v.cpu()
    parts = [torch.empty_like(v) for _ in range(mesh.dp)]
    dist.all_gather(parts, v, group=mesh.dp_group)
    return torch.cat(parts).cpu().numpy() == 1

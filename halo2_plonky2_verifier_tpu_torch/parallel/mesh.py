"""The (dp, qp) split of batched verification over torch.distributed ranks.

The counterpart of `halo2_plonky2_verifier_tpu/parallel/mesh.py`, on process
groups where JAX has a `Mesh`.  Two axes:
  dp: data parallelism over proofs (axis 0 of every batch field);
  qp: sharding of the independent FRI query rounds (axis 1 of the
      query-indexed fields, `witness.QUERY_FIELDS`).

Layout rule: proof-level fields are split over dp and replicated over qp;
the query-indexed fields are split over both.  Rank r sits at dp index
r // qp and qp index r % qp (qp varies fastest, so that the ranks of one qp
group are neighbours, as JAX keeps qp inside a host).  Every rank runs the
transcript and the vanishing check of its dp slice, verifies its own
queries, and the verdict is AND-reduced over its qp group
(`stark.and_over_group`, all_reduce MIN).

A world of one rank, or none (torch.distributed not initialised), gives
the unsharded verify.
"""

from dataclasses import dataclass, fields, replace
from typing import Any, Optional

import torch.distributed as dist

from ..stark import QueryShard, build_verifier
from ..utils.logging import get_logger
from ..witness import QUERY_FIELDS


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a dp x qp split of the world, with the process
    groups of its qp shards (`qp_group`) and of its dp shards
    (`dp_group`); both None when torch.distributed is not initialised."""
    dp: int
    qp: int
    rank: int
    qp_group: Optional[Any] = None
    dp_group: Optional[Any] = None

    @property
    def dp_index(self):
        return self.rank // self.qp

    @property
    def qp_index(self):
        return self.rank % self.qp

    @property
    def shape(self):
        return {"dp": self.dp, "qp": self.qp}


def mesh_split(n, dp=None, qp=None):
    """(dp, qp) for a world of n ranks.  Defaults, by the JAX rule: qp = 2
    when the world is even and larger than 1, else 1; dp = n / qp."""
    if dp is None or qp is None:
        qp = 2 if n % 2 == 0 and n > 1 else 1
        dp = n // qp
    if dp * qp != n:
        raise ValueError(f"dp={dp} x qp={qp} does not split {n} rank(s)")
    return dp, qp


def make_mesh(dp=None, qp=None):
    """Split the torch.distributed world (one rank if it is not
    initialised) into dp x qp ranks (`mesh_split`).  Every rank must call
    it, in the same order, since it creates process groups."""
    initialised = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    dp, qp = mesh_split(n, dp, qp)
    qp_group = dp_group = None
    if initialised:
        # every rank creates every group, in the same order
        for d in range(dp):
            g = dist.new_group([d * qp + j for j in range(qp)])
            if d == rank // qp:
                qp_group = g
        for j in range(qp):
            g = dist.new_group([d * qp + j for d in range(dp)])
            if j == rank % qp:
                dp_group = g
    get_logger(__name__).info(
        "make_mesh: dp=%d qp=%d over %d rank(s), backend %s", dp, qp, n,
        dist.get_backend() if initialised else "none")
    return Mesh(dp=dp, qp=qp, rank=rank, qp_group=qp_group,
                dp_group=dp_group)


def _split(n, parts, index, what):
    if n % parts:
        raise ValueError(f"{what}: {n} does not split into {parts} shards")
    per = n // parts
    return slice(index * per, (index + 1) * per)


def slice_batch(batch, proofs=slice(None), queries=slice(None)):
    """A ProofBatch of the proofs `proofs` (axis 0 of every field) and the
    query rounds `queries` (axis 1 of the query-indexed fields), each field
    contiguous.  The shape stays the batch's."""
    def cut(t, query):
        t = t[proofs]
        return (t[:, queries] if query else t).contiguous()

    out = {}
    for f in (x.name for x in fields(batch) if x.name != "shape"):
        v = getattr(batch, f)
        query = f in QUERY_FIELDS
        out[f] = (None if v is None else [cut(t, query) for t in v]
                  if isinstance(v, list) else cut(v, query))
    return replace(batch, **out)


def query_slice(num_queries, mesh):
    """This rank's slice of the query rounds."""
    return _split(num_queries, mesh.qp, mesh.qp_index, "queries")


def shard_batch(batch, mesh):
    """This rank's slice of a whole (loaded and checked) ProofBatch: axis 0
    split over dp for every field, axis 1 also over qp for the
    query-indexed fields."""
    return slice_batch(
        batch, _split(batch.batch_size, mesh.dp, mesh.dp_index, "proofs"),
        query_slice(batch.shape.num_queries, mesh))


def sharded_verifier(stark, config, degree_bits, mesh):
    """Returns verify(local_batch) -> this rank's (B / dp,) verdict, already
    AND-reduced over its qp group; `local_batch` is `shard_batch`'s slice.
    Without torch.distributed (no groups) it is the unsharded verifier."""
    shard = None
    if mesh.qp_group is not None:
        shard = QueryShard(mesh.qp_index, mesh.qp, mesh.qp_group)
    elif mesh.qp != 1:
        raise ValueError(f"qp={mesh.qp} needs the process groups of "
                         "make_mesh")
    return build_verifier(stark, config, degree_bits, query_shard=shard)

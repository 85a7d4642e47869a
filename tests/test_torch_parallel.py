"""The PyTorch port's sharded verification (`parallel/`), on the CPU: the
shard slicing against numpy slicing, the dp x qp split against the JAX
`make_mesh` rule, the query-shard checks, and worlds of gloo processes
whose gathered verdicts must equal the unsharded verify's and refimpl's.

The batch of the worlds is `tests/fixtures/fib_stark_n32_x8.jsonl` with
lane 2's public input bumped and lane 5's Merkle sibling of query 60
replaced: only the second of two query shards sees lane 5's fault, so the
AND over the shards is what rejects it.  The JAX verifier is never
compiled here.  Integer and boolean results: the tolerance is 0.
"""

import dataclasses
import json
import tempfile
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from halo2_plonky2_verifier_tpu.models.fibonacci import \
    FibonacciStark as JaxFibonacciStark
from halo2_plonky2_verifier_tpu.parallel.mesh import make_mesh as jax_make_mesh
from halo2_plonky2_verifier_tpu.refimpl import verifier as ref_verifier
from halo2_plonky2_verifier_tpu.refimpl.proof import \
    proof_from_json as jax_proof_from_json
from halo2_plonky2_verifier_tpu.utils.config import \
    StarkConfig as JaxStarkConfig
from halo2_plonky2_verifier_tpu_torch import build_verifier
from halo2_plonky2_verifier_tpu_torch import witness
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks as tgl
from halo2_plonky2_verifier_tpu_torch.parallel.dryrun import (
    dryrun_multichip, run_ranks, tiled_batch, world_verdicts)
from halo2_plonky2_verifier_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, mesh_split, shard_batch, sharded_verifier)
from halo2_plonky2_verifier_tpu_torch.fixtures import read_docs, tampered
from halo2_plonky2_verifier_tpu_torch.stark import QueryShard

SPEC = {"fixture": "fib_stark_n32_x8.jsonl", "family": "fibonacci",
        "num_rows": 32, "size": 8, "device": "cpu", "backend": "gloo",
        "tampers": {"2": "public_input", "5": "late_sibling"}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain path's ops are small, so more threads only contend for
    the cores with the other test processes: one thread for this file,
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batch():
    return tiled_batch(SPEC)


def _refimpl_verdicts():
    docs = read_docs(SPEC["fixture"])
    out = []
    for lane in range(SPEC["size"]):
        doc = docs[lane % len(docs)]
        if str(lane) in SPEC["tampers"]:
            doc = tampered(doc, SPEC["tampers"][str(lane)])
        try:
            ref_verifier.verify(JaxFibonacciStark(32),
                                jax_proof_from_json(json.dumps(doc)),
                                JaxStarkConfig.standard_fast_config())
            out.append(True)
        except ref_verifier.VerificationError:
            out.append(False)
    return out


@pytest.mark.parametrize("dp,qp", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2),
                                   (8, 4)])
def test_shard_batch_slices_like_numpy(batch, dp, qp):
    """Every rank's shard: axis 0 of every field cut over dp, axis 1 of the
    query-indexed fields also over qp, each equal to numpy slicing of the
    whole batch's u64 arrays; the shape stays the whole batch's."""
    whole = batch[3]
    for rank in range(dp * qp):
        mesh = Mesh(dp=dp, qp=qp, rank=rank)
        local = shard_batch(whole, mesh)
        assert local.shape == whole.shape
        b, q = 8 // dp, 84 // qp
        ps = slice(mesh.dp_index * b, (mesh.dp_index + 1) * b)
        qs = slice(mesh.qp_index * q, (mesh.qp_index + 1) * q)
        for f in (x.name for x in dataclasses.fields(whole)
                  if x.name != "shape"):
            got, full = getattr(local, f), getattr(whole, f)
            if full is None:
                assert got is None
                continue
            pairs = zip(got, full) if isinstance(full, list) else [(got, full)]
            for g, w in pairs:
                want = tgl.to_u64(w)[ps]
                if f in witness.QUERY_FIELDS:
                    want = want[:, qs]
                assert g.is_contiguous()
                assert np.array_equal(tgl.to_u64(g), want), f


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_default_split_matches_jax_make_mesh(n):
    """The port's default dp x qp split of n ranks is JAX make_mesh's of n
    devices (conftest gives JAX 8 virtual CPU devices); without
    torch.distributed make_mesh is one rank, 1 x 1."""
    mesh = jax_make_mesh(jax.devices()[:n])
    assert mesh_split(n) == (mesh.shape["dp"], mesh.shape["qp"])
    assert mesh_split(n, dp=n, qp=1) == (n, 1)
    one = make_mesh()
    assert (one.dp, one.qp, one.rank, one.qp_group) == (1, 1, 0, None)


def test_query_shards_must_split_the_queries(batch):
    """qp must divide the 84 queries, a shard's batch must hold its own
    query count, and a split must cover the world."""
    stark, config, degree_bits, whole = batch
    for count in (5, 8, 0):
        with pytest.raises(ValueError):
            build_verifier(stark, config, degree_bits,
                           query_shard=QueryShard(0, count, None))
    with pytest.raises(ValueError):
        shard_batch(whole, Mesh(dp=1, qp=5, rank=0))
    with pytest.raises(ValueError):
        shard_batch(whole, Mesh(dp=3, qp=1, rank=0))
    with pytest.raises(ValueError):
        mesh_split(4, dp=3, qp=1)
    with pytest.raises(ValueError):
        sharded_verifier(stark, config, degree_bits, Mesh(dp=1, qp=2, rank=0))
    # all 84 queries handed to shard 0 of 2 (the check runs before any
    # collective, so no group is needed)
    verify = build_verifier(stark, config, degree_bits,
                            query_shard=QueryShard(0, 2, None))
    with pytest.raises(ValueError, match="queries"):
        verify(whole)


def test_only_the_second_query_half_rejects_lane_5(batch, tmp_path):
    """In a world of one gloo rank, each query half verified alone: lane 5
    (a sibling of query 60 replaced) passes the first half and fails the
    second; lane 2 (a public input) fails both."""
    stark, config, degree_bits, whole = batch
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        got = []
        for index in (0, 1):
            local = shard_batch(whole, Mesh(dp=1, qp=2, rank=index))
            verify = build_verifier(
                stark, config, degree_bits,
                query_shard=QueryShard(index, 2, dist.group.WORLD))
            got.append(verify(local).tolist())
    finally:
        dist.destroy_process_group()
    assert got[0] == [True, True, False, True, True, True, True, True]
    assert got[1] == [True, True, False, True, True, False, True, True]


@pytest.fixture
def one_thread(monkeypatch, tmp_path):
    """The ranks share the host's cores and their ops are small: one thread
    each, so that they do not contend.  Their file-based rendezvous (a
    temp directory of `run_ranks`) lives under tmp_path."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def test_gloo_worlds_equal_unsharded_and_refimpl(batch, one_thread):
    """Worlds of 2 gloo processes (dp x qp = 1 x 2, then 2 x 1) and of 4
    (2 x 2), each rank loading only its dp slice: the gathered verdicts
    equal the unsharded verify's and refimpl's."""
    stark, config, degree_bits, whole = batch
    want = build_verifier(stark, config, degree_bits)(whole).tolist()
    assert want == _refimpl_verdicts()
    assert want == [True, True, False, True, True, False, True, True]
    runs = (world_verdicts({**SPEC, "meshes": [[1, 2], [2, 1]]}, 2, 240)
            + world_verdicts({**SPEC, "meshes": [[2, 2]]}, 4, 240))
    assert [(r["dp"], r["qp"]) for r in runs] == [(1, 2), (2, 1), (2, 2)]
    for r in runs:
        assert r["verdicts"] == want, r


def test_a_failed_or_late_rank_fails_the_world(one_thread):
    """A rank that exits non-zero ends the world at once, its peers killed,
    and is the one named; a world that outlives its limit is killed."""
    code = ("import sys, time\n"
            "if sys.argv[1] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited 3"):
        run_ranks(["-c", code], 3, 60)
    with pytest.raises(RuntimeError, match="outlived 1 s"):
        run_ranks(["-c", "import time; time.sleep(60)"], 2, 1)
    assert time.monotonic() - t0 < 30
    assert run_ranks(["-c", "import sys; print(sys.argv[1:3])"], 2, 60) == \
        ["['0', '2']\n", "['1', '2']\n"]


def test_dryrun_multichip_4(capsys, one_thread):
    dryrun_multichip(4, "cpu", timeout=240)
    assert ("dryrun_multichip(4): mesh {'dp': 2, 'qp': 2} on cpu, verdict OK"
            in capsys.readouterr().out)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the ranks would run on the card")
def test_dryrun_multichip_runs_on_the_card_unless_asked(one_thread):
    """Without a device the ranks load their proofs on the card; where
    there is none they fail, and nothing falls back to the CPU."""
    with pytest.raises(RuntimeError, match=r"rank \d exited"):
        dryrun_multichip(2, timeout=120)

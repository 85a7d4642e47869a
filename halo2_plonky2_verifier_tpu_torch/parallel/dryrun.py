"""Run a world of ranks as processes, and the multi-rank dry run.

`run_ranks` starts one Python process per rank, each with its rank, the
world size and a `file://` init method under a fresh temp directory on its
command line, gives the world one time limit, and raises if a rank fails
or outlives it (every rank is then killed).

`world_verdicts(spec, world_size, timeout)` runs a world that verifies one
fixture file tiled to a batch, some lanes tampered at the JSON level, under
each of a list of dp x qp splits: each rank loads only the proofs of its dp
slice (`distributed.local_batch_slice`), verifies its query slice
(`distributed_verifier`), and rank 0 reports the verdicts gathered over
dp.  `tools/torch_run_multihost_demo.py`, `chip_smoke.py` and the tests run
it; `tiled_batch` builds the same lanes for the unsharded verify they are
held against.

`dryrun_multichip(n, device)` is the port's counterpart of the JAX
package's `__graft_entry__.py:dryrun_multichip`: n ranks split
FibonacciStark n=8 proofs, 2 a dp shard, over the default dp x qp split
(`world_verdicts`), and every verdict must be True.  The ranks share the
card unless `device` is "cpu"; gloo unless each rank has a card of its own.

Usage: python3 -m halo2_plonky2_verifier_tpu_torch.parallel.dryrun [N]
[--device cuda|cpu] (default 8 ranks on the card).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from ..fixtures import read_docs, tampered
from ..interop import READERS
from ..models import make_stark
from ..utils.config import make_config
from .mesh import mesh_split

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_ranks(argv, world_size, timeout):
    """Run `python argv... RANK WORLD_SIZE INIT_METHOD` for every rank at
    once; returns each rank's stdout.  Raises RuntimeError, with the tail
    of its stderr, if a rank exits non-zero or the world is not done
    within `timeout` seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs, files = [], []
        try:
            for rank in range(world_size):
                files.append((open(os.path.join(tmp, f"{rank}.out"), "w+"),
                              open(os.path.join(tmp, f"{rank}.err"), "w+")))
                procs.append(subprocess.Popen(
                    [sys.executable, *argv, str(rank), str(world_size), init],
                    stdout=files[-1][0], stderr=files[-1][1], env=env,
                    cwd=REPO))
            deadline = time.monotonic() + timeout
            # a failed rank ends the world: the others may wait on it
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)):
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{argv}: the world of {world_size} "
                                       f"rank(s) outlived {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            texts = []
            for out, err in files:
                out.seek(0)
                err.seek(0)
                texts.append((out.read(), err.read()))
                out.close()
                err.close()
        # a rank that failed by itself before those killed after it
        failed = sorted((p.returncode < 0, rank) for rank, p in
                        enumerate(procs) if p.returncode)
        if failed:
            rank = failed[0][1]
            raise RuntimeError(f"{argv}: rank {rank} exited "
                               f"{procs[rank].returncode}:\n"
                               f"{texts[rank][1][-4000:]}")
        return [text for text, _ in texts]


def lane_docs(spec, lanes, docs):
    """The proof JSON dict of each lane of `lanes`: the fixture's proof
    lane % len(docs), under tamper spec["tampers"][lane] where one is
    given.  Lanes of one source share one dict."""
    fmt = spec.get("format", "native")
    tampers = {int(k): v for k, v in spec.get("tampers", {}).items()}
    made, out = {}, []
    for lane in lanes:
        key = (lane % len(docs), tampers.get(lane))
        if key not in made:
            i, t = key
            made[key] = docs[i] if t is None else tampered(docs[i], t, fmt)
        out.append(made[key])
    return out


def tiled_batch(spec, lanes=None):
    """The batch of `spec` (see `world_verdicts`): the fixture's proofs
    tiled to spec["size"] lanes, some tampered (`lane_docs`); only the
    lanes of range `lanes` (all by default) are loaded, on
    spec["device"], each distinct proof read and converted once.  Returns
    (stark, config, degree_bits, ProofBatch)."""
    import numpy as np

    from ..witness import batch_from_u64, proof_shape, proof_u64_fields

    stark = make_stark(spec)
    config = make_config(spec.get("config"))
    hasher = spec.get("hasher", "poseidon_goldilocks")
    docs = lane_docs(spec, range(spec["size"]) if lanes is None else lanes,
                     read_docs(spec["fixture"]))
    uniq = list({id(d): d for d in docs}.values())
    where = {id(d): k for k, d in enumerate(uniq)}
    proofs = [READERS[spec.get("format", "native")](d) for d in uniq]
    degree_bits = proofs[0].proof.recover_degree_bits(config)
    shape = proof_shape(stark, config, degree_bits, hasher)
    src = np.array([where[id(d)] for d in docs])
    fields = {f: (None if v is None else [x[src] for x in v]
                  if isinstance(v, list) else v[src])
              for f, v in proof_u64_fields(proofs, shape).items()}
    return stark, config, degree_bits, batch_from_u64(fields, shape,
                                                      spec["device"])


def world_verdicts(spec, world_size, timeout):
    """Run a world of `world_size` ranks over `spec`, a dict: "fixture"
    (a file of tests/fixtures, one proof a line), "format" ("native" or
    "plonky2"), "family" and "num_rows" (as a service request's "stark"),
    "hasher", "size" (lanes), "tampers" ({lane: a `fixtures.TAMPERS` name}),
    "device", "backend" and "meshes" ([[dp, qp], ...]).  Returns
    [{"dp", "qp", "verdicts"}] per mesh, the verdicts of the whole batch
    as rank 0 gathered them, with rank 0's wall time of the verify
    ("wall_ms") and launch count of each STARK-verifier kernel wrapper
    ("launches": K1-K6)."""
    outs = run_ranks(["-m", "halo2_plonky2_verifier_tpu_torch.parallel.dryrun",
                      "verify", json.dumps(spec)], world_size, timeout)
    return [json.loads(line) for line in outs[0].splitlines()
            if line.startswith("{")]


def _wrappers():
    from ..ops import bn254_kernels, merkle_kernels, transcript_kernels
    return {"K1": merkle_kernels.verify_paths_planes,
            "K2": transcript_kernels.run_steps_planes,
            "K3": merkle_kernels.hash_no_pad_planes,
            "K4": bn254_kernels.verify_paths_mont_planes,
            "K5": bn254_kernels.hash_or_noop_mont_planes,
            "K6": bn254_kernels.permute_planes}


def _verify_worker(spec, rank, world_size, init_method):
    wrappers = _wrappers()
    import torch.distributed as dist

    from .distributed import (distributed_verifier, global_batch,
                              global_verdict, initialize, local_batch_slice)
    from .mesh import make_mesh

    initialize(init_method, world_size, rank, backend=spec.get("backend"))
    for dp, qp in spec["meshes"]:
        mesh = make_mesh(dp, qp)
        start, per = local_batch_slice(spec["size"], mesh)
        stark, config, degree_bits, local = tiled_batch(
            spec, range(start, start + per))
        verify = distributed_verifier(stark, config, degree_bits, mesh)
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        verdict = global_verdict(verify(global_batch(local, mesh)), mesh)
        wall = time.perf_counter() - t0
        if rank == 0:
            print(json.dumps({
                "dp": dp, "qp": qp, "verdicts": verdict.tolist(),
                "wall_ms": wall * 1e3,
                "launches": {k: w.launches
                             for k, w in wrappers.items()}}),
                  flush=True)
    dist.destroy_process_group()


def dryrun_multichip(n_ranks, device="cuda", timeout=300):
    """n ranks verify 2 FibonacciStark n=8 proofs a dp shard on `device`,
    over the default dp x qp split; raises unless every verdict is
    True."""
    dp, qp = mesh_split(n_ranks)
    spec = {"fixture": "fib_stark_n8.json", "family": "fibonacci",
            "num_rows": 8, "size": 2 * dp, "device": device,
            "backend": "gloo" if device == "cpu" else None,
            "meshes": [[dp, qp]]}
    (run,) = world_verdicts(spec, n_ranks, timeout)
    if run["verdicts"] != [True] * spec["size"]:
        raise AssertionError(f"dryrun verdict failed: {run['verdicts']}")
    print(f"dryrun_multichip({n_ranks}): mesh {{'dp': {dp}, 'qp': {qp}}} "
          f"on {device}, verdict OK {json.dumps(run['verdicts'])}",
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["verify"]:
        _verify_worker(json.loads(sys.argv[2]), int(sys.argv[3]),
                       int(sys.argv[4]), sys.argv[5])
    else:
        ap = argparse.ArgumentParser(description="the multi-rank dry run")
        ap.add_argument("ranks", nargs="?", type=int, default=8)
        ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
        args = ap.parse_args()
        dryrun_multichip(args.ranks, args.device)

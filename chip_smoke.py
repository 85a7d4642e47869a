#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (written for an H100).

Drives `halo2_plonky2_verifier_tpu_torch` on the card, in phases:

  1. device: the card's name and power limit;
  2. build: nvcc for every kernel of the port, all at once;
  3. kernels: K1 (Merkle paths; also at the PLONK recmix drive's 4 x 28 x
     4096 paths of depth 4), K2 (transcript, B = 1024 and 4096, and the
     PLONK recmix schedule at both; also compared at a ragged B = 1023 and
     at B = 2048), K3 (leaf sponge, w = 32, the PLONK recmix drive's four
     oracle widths at 28 x 4096 leaves and the plonkish drives' 7-wide
     trace oracle at 84 x 1024 and 84 x 4096 leaves; also compared at N =
     1, 100 and a ragged 2 * 84 * 1024 + 1, each at w = 5, 7, 8, 9, 13 and
     32), K4 (BN254 Merkle paths; also compared at the serve drive's
     BN254-caps request, 3 x 84 x 4 paths of depth 2), K5 (BN254 leaf hash,
     w = 4, 2, 32 at the n=2^11 shapes and w = 4, 2 at the n=2^5 ones; also
     compared at ragged N, w = 13 and 4, and at the serve drive's
     BN254-caps shapes, w = 2 and 4 at 84 x 4 leaves a slot), K6 (the BN254 permutation), K7 (the bulk Goldilocks
     permutation, 2^17 and 2^21 states and the PLONK public-input hash's
     4096; also compared at 2^17 + 1),
     K8 (64 chained Goldilocks permutations on 2^18 states; also compared
     at chain 0 and 1 on 2^18 + 1), K10 (the gl_mul speed-of-light probe,
     256 dependent products on 8 x 2^21 elements, compared on a sample of
     lanes; also on every lane at chain 0, 1 and 2 on 8 x (2^21 + 1); the
     first lanes of both factors the Goldilocks edge values; its registers
     and spill from ptxas) and K9 (every run of
     `tools/torch_bn254_micro.py`: the probes of the BN254 body's functions
     at 2^16 lanes, and the u32, f32 and wide multiplier probes at 1, 4 and
     8 lanes a thread on 2^20 lanes, chain 64), each against its plain
     PyTorch version on the same seeded inputs at the shapes of the main
     paths; the results must be equal (tolerance 0: these are integers, and
     the f32 probe's values are integers below 2^17).  Both are timed on the
     card with CUDA events (the kernel: the median of 5 launches, each
     between its own pair of events, queued behind a sleep so that no host
     delay lands inside a pair).  The BN254 plain versions, K8's and K9's
     are compared on a sample of lanes (for K4 and K5 one that covers every
     Merkle slot, so every depth and width); the kernel is timed at the full
     shape.  K4's and K6's inputs include carry-stressing values (0, 1,
     p - 1, p - 2, words of all ones; for K4's siblings also values >= p) on
     compared lanes, and K6 is also compared on every lane at N = 4097 (a
     partial last group) and N = 1024.  K1's, K2's, K7's and the extra K3
     and K8 comparisons' first lanes, and K5's first compared lanes, hold
     the Goldilocks edge values (0, 1, p - 1, p - 2 and u64 values >= p).
     K9's two whole-permutation probes are compared at a chain of 2 and
     timed at the full chain, its multiplier probes compared on every lane;
     each K9 part records its launch's threads and blocks and its kernel
     instance's registers and spill;
  4. the drives, each with every kernel's launch count set to 0 just before
     it and read just after; every kernel of the drive must have launched:
     a. through `build_verifier` on a tiled fixture: every verdict must be
        True, a tampered batch must give the expected verdicts, and its
        first lanes must match the plain path run on the CPU (32 lanes
        Goldilocks, 8 BN254); none of K4-K9 but the drive's own may launch
        (`drive_batch`):
          GL fold shape      n=2^11 B=1024, Goldilocks caps and transcript
          GL flagship        n=2^5  B=4096
          BN254 fold shape   n=2^11 B=1024, BN254 caps, Goldilocks transcript
          BN254 flagship     n=2^5  B=4096, the same configuration
          all-BN254          n=2^5  B=4096, BN254 caps and BN254 transcript;
     b. through `plonk.build_plonk_verifier` on plonky2 PLONK proofs read
        from JSON (`proof_json.py`) against a circuit fixture
        (`circuit/common.py:load_circuit`), tiled to the batch: every
        verdict True, a tampered batch (`tamper_plonk`) giving the expected
        verdicts, its first lanes equal to the CPU plain path's; K1, K2, K3
        and K7 must launch and K4-K6, K8, K9 must not:
          PLONK recmix s60   the bench's PLONK circuit (standard_recursion
                             gate mix, 135 wires, 28 queries), B=4096
          PLONK recursive    the recursive verifier of recursive_fib_n8,
                             B=256
          PLONK logUp        the two-table logUp circuit, B=16, every lane
                             compared with the CPU;
     c. through `build_verifier` on PlonkishStark proofs read from JSON
        (`plonkish_n2048_x8.jsonl`, `plonkish_n32_x8.jsonl`), tiled, as in
        a. (`drive_plonkish`); K1, K2 and K3 (the 7-wide trace oracle)
        must launch, K4-K9 must not:
          plonkish fold shape  n=2^11 B=1024
          plonkish flagship    n=2^5  B=4096;
     d. serve: a `serve.VerifierService` on the card answers a JSONL
        stream (`drive_serve`): FibonacciStark n=2^5 in the repo's JSON
        at 3 proofs (bucket 4), PlonkishStark n=2^11 at B=1024,
        PlonkishStark n=2^5 in plonky2's serde JSON, FibonacciStark n=2^5
        with BN254 caps, each with tampered lanes, a malformed line, and
        the first request again; every verdict must equal the direct
        `build_verifier` verdict on the same lanes, the repeat must have
        `compile_s` null, the malformed line an error; K1-K5 launch;
     e. sharded (`drive_sharded`): a one-rank NCCL world in this process
        runs `parallel.mesh.sharded_verifier` on the GL n=2^11 B=1024
        batch of a. (tampered), its verdicts equal to the unsharded
        verify's, both timed; then a world of 2 processes on the same card
        (gloo, each its own time limit) verifies FibonacciStark n=2^11
        B=1024 from JSON under dp=1 qp=2 and dp=2 qp=1, with lanes whose
        bad Merkle sibling only the second query shard sees; its gathered
        verdicts must equal the unsharded verify's;
     f. GL bulk hash: the batch-last `permute`, `hash_no_pad` at k = 8, 13
        and 60 and `two_to_one` of `ops/poseidon.py`, each on 2^17 seeded
        lanes (K7), the first 64 lanes equal to the plain path on the CPU;
     g. census: `utils/profiling.py` takes the op census of one proof on
        the card, the kernels running (`drive_census`): GL n=2^11 (K1-K3),
        GL n=2^5 (K1, K2) and the PLONK recmix circuit (K1-K3, K7); every
        total must equal its `CENSUS_ANCHORS` entry;
     h. SOL probes: `tools/torch_sol_bench.py:measure_poseidon_sol` (K7, K8,
        K1), each probe's M perm/s and share of its bound, and
        `measure_gl_mul_sol` (K10), the Goldilocks products a second and
        their share of the bound; then, on a line of its own, the port's
        figures of BASELINE.json's second metric: gl_mul per proof (the
        census) x each GL drive's proofs/s, and its percent of K10's rate;
     i. BN254 component probes: `tools/torch_bn254_micro.py:measure` (K9),
        ns per iteration per lane of each run, each run's time beside its
        time in phase 3, the sum of the rounds beside the permutation, the
        partial round's x2/x1 ratio, and each multiplier run's multiplies a
        clock an SM;
  5. one JSON line listing the kernels (launches per drive, times, the
     least time the card could take for the same work), the service's
     responses and the sharded walls, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises, and the script exits non-zero without the last line.

Usage: python3 chip_smoke.py        (needs one CUDA card and nvcc)
"""

import io
import json
import math
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from halo2_plonky2_verifier_tpu_torch import (StarkConfig, build_verifier,
                                              fixtures, plonk, proof_json,
                                              proof_shape, serve, stark,
                                              transcript, witness)
from halo2_plonky2_verifier_tpu_torch.circuit import load_circuit
from halo2_plonky2_verifier_tpu_torch.models.fibonacci import FibonacciStark
from halo2_plonky2_verifier_tpu_torch.models.plonkish import PlonkishStark
from halo2_plonky2_verifier_tpu_torch.ops import _build
from halo2_plonky2_verifier_tpu_torch.ops import bn254 as fr
from halo2_plonky2_verifier_tpu_torch.ops import bn254_kernels as bk
from halo2_plonky2_verifier_tpu_torch.ops import bn254_micro_kernels as mk9
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks as gl
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks_kernels as glk
from halo2_plonky2_verifier_tpu_torch.ops import merkle_kernels as mk
from halo2_plonky2_verifier_tpu_torch.ops import poseidon as pos
from halo2_plonky2_verifier_tpu_torch.ops import poseidon_kernels as pk
from halo2_plonky2_verifier_tpu_torch.ops import transcript_kernels as tk
from halo2_plonky2_verifier_tpu_torch.parallel import distributed
from halo2_plonky2_verifier_tpu_torch.parallel.dryrun import (lane_docs,
                                                              tiled_batch,
                                                              world_verdicts)
from halo2_plonky2_verifier_tpu_torch.parallel.mesh import (make_mesh,
                                                            shard_batch,
                                                            sharded_verifier)
from halo2_plonky2_verifier_tpu_torch.utils import profiling
from halo2_plonky2_verifier_tpu_torch.utils.roofline import (BN_MONT_MUL,
                                                            BN_PERM_MULS,
                                                            BN_REDC,
                                                            GL_PERM_MULS,
                                                            bound,
                                                            gl_mul_chain)
from halo2_plonky2_verifier_tpu_torch.utils.timing import cuda_ms

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.append(os.path.join(REPO, "tools"))
import torch_bn254_micro  # noqa: E402
import torch_sol_bench  # noqa: E402

FIXTURES = os.path.join(REPO, "tests", "fixtures")
SEED = 20261016
DEVICE = "cuda"
BN = "poseidon_bn254"
GLH = "poseidon_goldilocks"

WRAPPERS = {"K1": mk.verify_paths_planes, "K2": tk.run_steps_planes,
            "K3": mk.hash_no_pad_planes, "K4": bk.verify_paths_mont_planes,
            "K5": bk.hash_or_noop_mont_planes, "K6": bk.permute_planes,
            "K7": pk.permute_planes, "K8": pk.permute_planes_chained,
            "K9": mk9.run_probe, "K10": glk.mul_chain}

# The op census of one proof that the census drive holds the card to: the
# JAX package's census (tests/fixtures/census_anchors.json, written by
# tools/gen_torch_census_anchors.py) with the port's divergences in the
# vanishing_poly_check scope (ROADMAP.md §3), pinned by
# tests/test_torch_census.py.  JAX: GL n=2^11 2,008,372 / 1,503,104 /
# 4,089; recmix 846,987 / 633,314 / 1,476.
CENSUS_ANCHORS = {
    "gl_n2048": {"gl_mul": 2_008_436, "gl_add": 1_503_168,
                 "poseidon_permute": 4_089},
    "gl_n32": {"gl_mul": 289_090, "gl_add": 216_036,
               "poseidon_permute": 551},
    "plonk_recmix_s60": {"gl_mul": 746_631, "gl_add": 584_158,
                         "poseidon_permute": 1_476},
}


def log(msg):
    print(msg, flush=True)


def rand_gl(rng, shape):
    """Seeded field elements below p, with 0 and p - 1 among them."""
    x = rng.integers(0, gl.P, size=shape, dtype=np.uint64)
    flat = x.reshape(-1)
    flat[0] = 0
    flat[1] = gl.P - 1
    return x


def rand_fr(rng, shape):
    """Seeded BN254 elements below p as (..., 4) uint64 words: the top word
    stays below p's, so every value is canonical."""
    x = rng.integers(0, np.iinfo(np.uint64).max, size=shape + (4,),
                     dtype=np.uint64, endpoint=True)
    x[..., 3] %= np.uint64(fr.P >> 192)
    return x


# Fr values that stress carries and reductions: 0, 1, p - 1, p - 2 and
# values whose low words are all ones (all canonical); siblings, which may
# be any 256-bit value, also take p, p + 1, 2p and 2^256 - 1.
EDGE_FR = (0, 1, fr.P - 1, fr.P - 2, (1 << 64) - 1, (1 << 128) - 1,
           (1 << 192) - 1, (fr.P >> 192 << 192) - 1)
EDGE_WIDE = EDGE_FR + (fr.P, fr.P + 1, 2 * fr.P, (1 << 256) - 1)


def edge_planes(values):
    """(4, len(values)) int64 word planes of host ints, on the card."""
    return fr.from_ints(list(values), DEVICE).T


def max_abs_err(a, b):
    """Largest |a - b| over the u64 values of two int64 tensors."""
    x, y = gl.to_u64(a), gl.to_u64(b)
    if x.shape != y.shape:
        raise AssertionError(f"shape {x.shape} != {y.shape}")
    return float(np.where(x >= y, x - y, y - x).max()) if x.size else 0.0


def fibonacci_shape(num_rows, degree_bits, hasher=GLH):
    """(stark, config, shape) of FibonacciStark under standard_fast_config."""
    fib = FibonacciStark(num_rows)
    config = StarkConfig.standard_fast_config()
    return fib, config, proof_shape(fib, config, degree_bits, hasher)


def path_inputs(rng, depths, m, node_words, sib_words):
    """K1/K4 inputs with the slots of the verifier's merged Merkle check:
    node (4, S*m), siblings (d_max, 4, S*m), idx, active.  node_words and
    sib_words are the hashes as (S*m, 4) and (d_max, S*m, 4) uint64 words,
    made by the caller."""
    d_max, n = max(depths), len(depths) * m
    node = gl.from_u64(node_words(n).T.copy(), DEVICE)
    sib = gl.from_u64(sib_words(d_max, n).transpose(0, 2, 1).copy(), DEVICE)
    idx = torch.from_numpy(rng.integers(0, 1 << d_max, size=n)).to(DEVICE)
    level_active = np.zeros((d_max, len(depths)), dtype=np.int32)
    for s_, d in enumerate(depths):
        level_active[:d, s_] = 1
    active = torch.from_numpy(np.repeat(level_active, m, axis=1)).to(DEVICE)
    return node, sib, idx, active


# Goldilocks words that stress the reductions: 0, 1, p - 1, p - 2, and the
# u64 values >= p that a tampered proof can carry.
EDGE_GL = (0, 1, gl.P - 1, gl.P - 2, gl.P, gl.P + 1, (1 << 64) - 1, 1 << 63)

# (fixture, (num_rows, degree_bits)) whose transcript schedule K2 runs
TRANSCRIPT_N11 = ("fib_stark_n2048_x8.npz", (2048, 11))
TRANSCRIPT_N5 = ("fib_stark_n32_x32.npz", (32, 5))


def with_gl_edges(planes, shift=0, lanes=None):
    """Set the first len(EDGE_GL) lanes of (rows, N) int64 planes (or the
    given `lanes`), in place, to the edge values, rotated by the row (plus
    `shift`)."""
    if lanes is None:
        lanes = torch.arange(min(len(EDGE_GL), planes.shape[1]))
    rows, k = planes.shape[0], len(lanes)
    vals = [[EDGE_GL[(r + j + shift) % len(EDGE_GL)] for j in range(k)]
            for r in range(rows)]
    planes[:, lanes.to(planes.device)] = gl.from_u64(vals, planes.device)


def schedule_inputs(rng, sched, b):
    """K2 inputs for a transcript schedule: seeded chunks (n_steps, 8, b),
    the first lanes of every step made of the edge values, and the
    schedule's mask (n_steps, 8)."""
    _, mask = transcript.schedule_tables(sched, DEVICE)
    chunks = gl.from_u64(rand_gl(rng, (len(sched.steps), 8, b)), DEVICE)
    for s_ in range(chunks.shape[0]):
        with_gl_edges(chunks[s_], shift=s_)
    return chunks, mask


def transcript_inputs(rng, fixture, b):
    """K2 inputs for the verifier's transcript schedule of `fixture`'s
    proofs (see `schedule_inputs`)."""
    name, (num_rows, degree_bits) = fixture
    shape = fibonacci_shape(num_rows, degree_bits)[2]
    one = witness.load_batch_npz(os.path.join(FIXTURES, name), shape, "cpu")
    sched, _, _ = stark.challenge_stream(one)
    return schedule_inputs(rng, sched, b)


# the PLONK drives' circuits: (fixture tag, proofs file); the recmix drive
# verifies PLONK_B proofs (bench.py's BENCH_CONFIG=plonk)
PLONK_B = 4096
RECMIX = ("recmix_s60", "plonk_recmix_s60_x32.jsonl")
RECURSIVE_FIB = ("recursive_fib_n8", "recursive_fib_n8_x2.jsonl")
LOGUP = ("logup", "plonk_logup_x4.jsonl")


def tile_fields(fields, size):
    """{field: uint64 arrays} with every array tiled up to `size` lanes."""
    def tile(x):
        reps = -(-size // x.shape[0])
        return np.concatenate([x] * reps, axis=0)[:size].copy()

    return {k: (None if v is None else [tile(x) for x in v]
                if isinstance(v, list) else tile(v))
            for k, v in fields.items()}


def plonk_fields(circuit, size):
    """A circuit fixture and its proofs file read through the port's
    readers: (common, verifier_data, shape, fields tiled to `size`)."""
    tag, proofs_file = circuit
    common, vd, _ = load_circuit(
        os.path.join(FIXTURES, f"plonk_circuit_{tag}.json"))
    shape = plonk.plonk_proof_shape(common)
    proofs = proof_json.read_jsonl(os.path.join(FIXTURES, proofs_file),
                                   proof_json.plonk_proof_from_json)
    fields = plonk.plonk_u64_fields(proofs, shape, vd)
    return common, vd, shape, tile_fields(fields, size)


def plonk_schedule_inputs(rng, b):
    """K2 inputs for the transcript schedule of the recmix PLONK proofs."""
    _, vd, shape, fields = plonk_fields(RECMIX, 1)
    one = plonk.plonk_batch_from_u64(fields, shape, "cpu")
    return schedule_inputs(rng, plonk.plonk_challenge_stream(one, vd)[1], b)


def sample_lanes(n, groups, per_group):
    """`per_group` evenly spaced lanes of each of `groups` equal slots."""
    m = n // groups
    step = max(1, m // per_group)
    return torch.cat([torch.arange(g * m, (g + 1) * m, step)[:per_group]
                      for g in range(groups)]).to(DEVICE)


def check_kernels(rng, B=1024, Q=84):
    """Phase 3: each kernel against its plain version at main-path shapes
    (B proofs of Q queries).  Returns {K: stats}."""
    m = B * Q
    # the PLONK recmix drive's geometry: pm lanes a Merkle slot
    rshape = plonk_fields(RECMIX, 1)[2]
    pm = rshape.num_queries * PLONK_B
    # K -> list of (kernel fn, plain fn, pick, what, (bound_ms, bound_by) of
    # the timed run, timed fn or None for the kernel fn)
    cases = {}
    # K -> list of (kernel fn, plain fn, what), compared on every lane only
    checks = {}

    # K1: the n=2^11 slots (3 oracles of depth 8, step trees of depth 4, 0),
    # the first lanes' node and siblings made of the edge values
    depths = (8, 8, 8, 4, 0)
    node, sib, idx, active = path_inputs(
        rng, depths, m, lambda n: rand_gl(rng, (n, 4)),
        lambda d, n: rand_gl(rng, (d, n, 4)))
    n, d_max = node.shape[1], sib.shape[0]
    with_gl_edges(node)
    for level in range(d_max):
        with_gl_edges(sib[level], shift=level + 1)
    args = (node, sib, idx, active)
    cases["K1"] = [(lambda: mk.verify_paths_planes(*args),
                    lambda: mk.verify_paths_planes_plain(*args), None,
                    f"N={n} d_max={d_max}",
                    bound(n * (32 + 8 + 32) + d_max * n * (32 + 4),
                          int(active.sum()) * GL_PERM_MULS), None)]
    # and the PLONK recmix drive's: 4 oracles of its initial depth
    pdepth = rshape.initial_depth
    pargs = path_inputs(rng, (pdepth,) * 4, pm,
                        lambda n: rand_gl(rng, (n, 4)),
                        lambda d, n: rand_gl(rng, (d, n, 4)))
    with_gl_edges(pargs[0])
    for level in range(pargs[1].shape[0]):
        with_gl_edges(pargs[1][level], shift=level + 1)
    pn = pargs[0].shape[1]
    cases["K1"].append((
        lambda: mk.verify_paths_planes(*pargs),
        lambda: mk.verify_paths_planes_plain(*pargs), None,
        f"PLONK recmix N={pn} d_max={pdepth}",
        bound(pn * (32 + 8 + 32) + pdepth * pn * (32 + 4),
              int(pargs[3].sum()) * GL_PERM_MULS), None))

    # K2: the transcript schedules of the n=2^11 proofs at B=1024 and of the
    # flagship n=2^5 proofs at B=4096, both timed; also compared (not timed)
    # at a ragged B=1023 and at B=2048 of the n=2^11 schedule.  The chunks'
    # first lanes are made of the edge values; every lane is compared.
    cases["K2"] = []
    for fixture, b_ in ((TRANSCRIPT_N11, B), (TRANSCRIPT_N5, 4 * B)):
        chunks, mask = transcript_inputs(rng, fixture, b_)
        n_steps = chunks.shape[0]
        cases["K2"].append((
            (lambda c=chunks, k=mask: tk.run_steps_planes(c, k)),
            (lambda c=chunks, k=mask: tk.run_steps_planes_plain(c, k)), None,
            f"n_steps={n_steps} B={b_}",
            bound(2 * chunks.numel() * 8 + mask.numel() * 4,
                  n_steps * b_ * GL_PERM_MULS), None))
    # the PLONK recmix schedule at B=1024 (16 lanes a proof) and at the
    # drive's B=4096 (4 lanes)
    for b_ in (B, PLONK_B):
        chunks, mask = plonk_schedule_inputs(rng, b_)
        n_steps = chunks.shape[0]
        cases["K2"].append((
            (lambda c=chunks, k=mask: tk.run_steps_planes(c, k)),
            (lambda c=chunks, k=mask: tk.run_steps_planes_plain(c, k)), None,
            f"PLONK recmix n_steps={n_steps} B={b_}",
            bound(2 * chunks.numel() * 8 + mask.numel() * 4,
                  n_steps * b_ * GL_PERM_MULS), None))
    # (B=1023 runs a ragged last group of 16 lanes; B=2048 the 4-lane form)
    checks["K2"] = [
        ((lambda c=c, k=k: tk.run_steps_planes(c, k)),
         (lambda c=c, k=k: tk.run_steps_planes_plain(c, k)),
         f"n_steps={c.shape[0]} B={c.shape[2]}")
        for c, k in (transcript_inputs(rng, TRANSCRIPT_N11, b_)
                     for b_ in (B - 1, 2 * B))]

    # K3: the two step-leaf slots of the n=2^11 proofs, w=32; also compared
    # (not timed) on every lane at fewer lanes than SMs (1, 100) and at a
    # ragged N, at widths of one partial chunk (5), whole chunks (8, 32) and
    # a partial last chunk (9, 13), the first lanes the edge values
    leaves = gl.from_u64(rand_gl(rng, (32, 2 * m)), DEVICE)
    cases["K3"] = [(lambda: mk.hash_no_pad_planes(leaves),
                    lambda: mk.hash_no_pad_planes_plain(leaves), None,
                    f"w=32 N={2 * m}",
                    bound(leaves.numel() * 8 + 2 * m * 32,
                          4 * 2 * m * GL_PERM_MULS), None)]
    # and the PLONK recmix drive's four oracle widths, one launch each
    for w in rshape.oracle_widths:
        x3 = gl.from_u64(rand_gl(rng, (w, pm)), DEVICE)
        with_gl_edges(x3)
        cases["K3"].append((
            (lambda x=x3: mk.hash_no_pad_planes(x)),
            (lambda x=x3: mk.hash_no_pad_planes_plain(x)), None,
            f"PLONK recmix w={w} N={pm}",
            bound(x3.numel() * 8 + pm * 32,
                  math.ceil(w / 8) * pm * GL_PERM_MULS), None))
    # and the plonkish drives' trace oracle, w=7: n=2^11 over B x Q leaves,
    # n=2^5 over 4B x Q
    for n3 in (m, 4 * m):
        x3 = gl.from_u64(rand_gl(rng, (7, n3)), DEVICE)
        with_gl_edges(x3)
        cases["K3"].append((
            (lambda x=x3: mk.hash_no_pad_planes(x)),
            (lambda x=x3: mk.hash_no_pad_planes_plain(x)), None,
            f"plonkish w=7 N={n3}",
            bound(x3.numel() * 8 + n3 * 32, n3 * GL_PERM_MULS), None))
    checks["K3"] = []
    for lanes in (1, 100, 2 * m + 1):
        for w in (5, 7, 8, 9, 13, 32):
            x = rand_gl(rng, (w, lanes))
            x[:, ::1021] |= np.uint64(0xFFFFFFFF00000000)
            x = gl.from_u64(x, DEVICE)
            with_gl_edges(x)
            checks["K3"].append(((lambda x=x: mk.hash_no_pad_planes(x)),
                                 (lambda x=x: mk.hash_no_pad_planes_plain(x)),
                                 f"w={w} N={lanes}"))

    # K4: the BN254 fold shape's slots, node in Montgomery form, some
    # siblings >= p (as in a tampered proof); the plain version on 64 lanes
    # of each slot, the first 8 of which take the edge values (node EDGE_FR,
    # siblings EDGE_WIDE, shifted by one a level)
    def bn_sibs(d, n):
        s = rand_fr(rng, (d, n))
        s[0, ::997, 3] = np.uint64(0xFFFFFFFFFFFFFFFF)
        return s

    bnode, bsib, bidx, bactive = path_inputs(
        rng, depths, m, lambda n: rand_fr(rng, (n,)), bn_sibs)
    pick = sample_lanes(bnode.shape[1], len(depths), 64)
    edge = pick.reshape(len(depths), 64)[:, :len(EDGE_FR)].reshape(-1)
    bnode[:, edge] = edge_planes(EDGE_FR * len(depths))
    for level in range(d_max):
        vals = EDGE_WIDE[level:] + EDGE_WIDE[:level]
        bsib[level][:, edge] = edge_planes(vals[:len(EDGE_FR)] * len(depths))
    bargs = (bnode, bsib, bidx, bactive)
    sub = (bnode[:, pick].contiguous(), bsib[:, :, pick].contiguous(),
           bidx[pick].contiguous(), bactive[:, pick].contiguous())
    n_act = int(bactive.sum())
    cases["K4"] = [(lambda: bk.verify_paths_mont_planes(*bargs),
                    lambda: bk.verify_paths_mont_planes_plain(*sub), pick,
                    f"N={bnode.shape[1]} d_max={d_max} (plain on "
                    f"N={pick.numel()})",
                    bound(n * (32 + 8 + 32) + d_max * n * (32 + 4),
                          n_act * (BN_PERM_MULS + BN_MONT_MUL) + n * BN_REDC),
                    None)]
    # and the serve drive's BN254-caps request (fibonacci n=32, bucket 4):
    # three slots of depth 2 over 4 x Q lanes, compared on every lane
    sargs = path_inputs(rng, (2, 2, 2), 4 * Q,
                        lambda n: rand_fr(rng, (n,)), bn_sibs)
    checks["K4"] = [((lambda: bk.verify_paths_mont_planes(*sargs)),
                     (lambda: bk.verify_paths_mont_planes_plain(*sargs)),
                     f"serve BN254 caps N={sargs[0].shape[1]} d_max=2")]

    # K5: the BN254 drives' leaf widths, one launch each: the fold shape's
    # three (B proofs) and the flagships' two (4B proofs), the plain version
    # on 128 lanes of each slot, the first 8 of which take the Goldilocks
    # edge values (words >= p included: the packing takes any u64); also
    # compared (not timed) on every lane at ragged N, the sponge's last
    # chunk partial (w = 13) and whole (w = 4), and at the serve drive's
    # BN254-caps shapes (fibonacci n=32, bucket 4: w=2 over two slots, w=4)
    cases["K5"] = []
    for w, lanes, slots in ((4, m, 1), (2, 2 * m, 2), (32, 2 * m, 2),
                            (4, 4 * m, 1), (2, 8 * m, 2)):
        x = gl.from_u64(rand_gl(rng, (w, lanes)), DEVICE)
        pick5 = sample_lanes(lanes, slots, 128)
        with_gl_edges(x, lanes=pick5[:len(EDGE_GL)])
        xs = x[:, pick5].contiguous()
        perms = 0 if w <= 3 else math.ceil(w / 9)
        conv = 1 if w <= 3 else math.ceil(w / 3)
        cases["K5"].append((
            (lambda x=x: bk.hash_or_noop_mont_planes(x)),
            (lambda xs=xs: bk.hash_or_noop_mont_planes_plain(xs)), pick5,
            f"w={w} N={lanes} (plain on N={pick5.numel()})",
            bound(x.numel() * 8 + lanes * 32,
                  lanes * (perms * BN_PERM_MULS + conv * BN_MONT_MUL)), None))
    checks["K5"] = []
    for w, lanes in ((13, 4 * B + 1), (4, B - 1),
                     (2, 8 * Q), (4, 4 * Q)):
        x = gl.from_u64(rand_gl(rng, (w, lanes)), DEVICE)
        with_gl_edges(x)
        checks["K5"].append(((lambda x=x: bk.hash_or_noop_mont_planes(x)),
                             (lambda x=x: bk.hash_or_noop_mont_planes_plain(x)),
                             f"w={w} N={lanes}"))

    # K6: one BN254 transcript step of the all-BN254 drive, B=4096, whole,
    # its first states made of the edge values; also compared (not timed)
    # on every lane at N=4097, whose last group of four lanes is partial,
    # and at N=1024
    def bn_states(nb):
        x = rand_fr(rng, (nb, 4))
        for j in range(min(nb, len(EDGE_FR))):  # state j: EDGE_FR rotated
            for e in range(4):
                v = EDGE_FR[(j + e) % len(EDGE_FR)]
                x[j, e] = [(v >> (64 * k)) & ((1 << 64) - 1)
                           for k in range(4)]
        return gl.from_u64(x.reshape(nb, 16).T.copy(), DEVICE)

    nb = 4 * B
    st = bn_states(nb)
    cases["K6"] = [(lambda: bk.permute_planes(st),
                    lambda: bk.permute_planes_plain(st), None,
                    f"N={nb} (one transcript step)",
                    bound(2 * st.numel() * 8, nb * BN_PERM_MULS), None)]
    checks["K6"] = [((lambda x=x: bk.permute_planes(x)),
                     (lambda x=x: bk.permute_planes_plain(x)), f"N={k}")
                    for k, x in ((k, bn_states(k)) for k in (nb + 1, B))]

    # K7: the GL bulk-hash drive's 2^17 states and the SOL bench's streamed
    # probe, 2^21 states, every lane compared; some lanes hold words >= p
    # (the kernel takes any u64), the first ones the edge values; also
    # compared (not timed) on every lane at a ragged N = 2^17 + 1
    cases["K7"] = []
    for n7 in (1 << 17, 1 << 21):
        x7 = rand_gl(rng, (12, n7))
        x7[:, ::1021] |= np.uint64(0xFFFFFFFF00000000)
        st7 = gl.from_u64(x7, DEVICE)
        with_gl_edges(st7)
        cases["K7"].append((
            (lambda st7=st7: pk.permute_planes(st7)),
            (lambda st7=st7: pk.permute_planes_plain(st7)), None, f"N={n7}",
            bound(2 * st7.numel() * 8, n7 * GL_PERM_MULS), None))
    # and the PLONK drive's public-input hash: one permutation a proof
    st7p = gl.from_u64(rand_gl(rng, (12, PLONK_B)), DEVICE)
    with_gl_edges(st7p)
    cases["K7"].append((
        (lambda: pk.permute_planes(st7p)),
        (lambda: pk.permute_planes_plain(st7p)), None,
        f"PLONK public-input hash N={PLONK_B}",
        bound(2 * st7p.numel() * 8, PLONK_B * GL_PERM_MULS), None))
    st7 = gl.from_u64(rand_gl(rng, (12, (1 << 17) + 1)), DEVICE)
    with_gl_edges(st7)
    checks["K7"] = [((lambda: pk.permute_planes(st7)),
                     (lambda: pk.permute_planes_plain(st7)),
                     f"N={st7.shape[1]}")]

    # K8: the SOL bench's chained probe, chain 64 over 2^18 states; the
    # plain version on 4096 lanes
    n8, chain8 = 1 << 18, 64
    st8 = gl.from_u64(rand_gl(rng, (12, n8)), DEVICE)
    pick8 = sample_lanes(n8, 1, 4096)
    sub8 = st8[:, pick8].contiguous()
    cases["K8"] = [(lambda: pk.permute_planes_chained(st8, chain8),
                    lambda: pk.permute_planes_chained_plain(sub8, chain8),
                    pick8, f"chain={chain8} N={n8} (plain on "
                    f"N={pick8.numel()})",
                    bound(2 * st8.numel() * 8, n8 * chain8 * GL_PERM_MULS),
                    None)]
    # (also compared on every lane at chain 0, a copy, and chain 1 on a
    # ragged N = 2^18 + 1, the first lanes the edge values)
    st8r = gl.from_u64(rand_gl(rng, (12, n8 + 1)), DEVICE)
    with_gl_edges(st8r)
    checks["K8"] = [
        ((lambda c=c: pk.permute_planes_chained(st8r, c)),
         (lambda c=c: pk.permute_planes_chained_plain(st8r, c)),
         f"chain={c} N={n8 + 1}") for c in (0, 1)]

    # K9: every run of tools/torch_bn254_micro.py at its lanes and chain.
    # The Fr probes' plain version runs on 4096 lanes, the whole
    # permutation's (both forms) at a chain of 2 (one plain BN254
    # permutation takes about half a second on the card), the kernel timed
    # at the full chain; the multiplier probes are compared on every lane
    # at the full chain.  Each part records its launch (threads, blocks)
    # and its kernel instance's registers and spill (-Xptxas -v).
    lanes9, chain9 = torch_bn254_micro.LANES, torch_bn254_micro.CHAIN
    pick9 = sample_lanes(lanes9, 1, 4096)
    usage9 = torch_bn254_micro.built_usage()
    cases["K9"] = []
    for name, threads, k in torch_bn254_micro.RUNS:
        n9 = torch_bn254_micro.run_lanes(name)
        x = torch_bn254_micro.probe_input(name, n9, rng, DEVICE)
        mul = name in mk9.MULTIPLIERS
        pick = None if mul else pick9
        xs = x if mul else x[:, pick9].contiguous()
        c = 2 if name.startswith("permute") else chain9
        reg = usage9.get(torch_bn254_micro.kernel_instance(name, threads, k),
                         {})

        def launch9(name=name, threads=threads, k=k, reg=reg):
            t, b = mk9.run_probe.last_launch
            return {"probe": name, "threads": threads, "k": k,
                    "launch_threads": t, "launch_blocks": b, **reg}

        cases["K9"].append((
            (lambda x=x, name=name, c=c, t=threads, k=k:
             mk9.run_probe(name, x, c, t, k)),
            (lambda xs=xs, name=name, c=c:
             mk9.run_probe_plain(name, xs, c)), pick,
            f"{name} threads={threads} k={k} N={n9} chain={chain9} (plain "
            f"on N={xs.shape[1]}, chain={c})",
            torch_bn254_micro.probe_bound(name, n9, chain9),
            (lambda x=x, name=name, t=threads, k=k:
             mk9.run_probe(name, x, chain9, t, k)), launch9))

    # K10: the gl_mul speed-of-light probe of tools/torch_sol_bench.py, chain
    # 256 over 8 x 2^21 elements, the plain version on 4096 lanes of each
    # row, the first lanes of x and y the edge values; also compared (not
    # timed) on every lane at chain 0, 1 and 2 on a ragged 8 x (2^21 + 1)
    n10, chain10 = 1 << 21, 256
    x10, y10 = (gl.from_u64(rand_gl(rng, (8, n10)), DEVICE) for _ in "xy")
    with_gl_edges(x10)
    with_gl_edges(y10, shift=3)
    pick10 = sample_lanes(n10, 1, 4096)
    xs10, ys10 = x10[:, pick10].contiguous(), y10[:, pick10].contiguous()
    cases["K10"] = [(lambda: glk.mul_chain(x10, y10, chain10),
                     lambda: glk.mul_chain_plain(xs10, ys10, chain10), pick10,
                     f"chain={chain10} N=8x{n10} (plain on "
                     f"N=8x{pick10.numel()})",
                     bound(*gl_mul_chain(x10.numel(), chain10)), None,
                     lambda: {"ptxas": torch_bn254_micro.ptxas_usage(
                         (_build.BUILD_DIR / "gl_mul_chain.log").read_text())})]
    x10r, y10r = (gl.from_u64(rand_gl(rng, (8, n10 + 1)), DEVICE)
                  for _ in "xy")
    with_gl_edges(x10r)
    with_gl_edges(y10r, shift=3)
    checks["K10"] = [
        ((lambda c=c: glk.mul_chain(x10r, y10r, c)),
         (lambda c=c: glk.mul_chain_plain(x10r, y10r, c)),
         f"chain={c} N=8x{n10 + 1}") for c in (0, 1, 2)]

    for name, parts in checks.items():
        for kernel, plain, what in parts:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if err != 0.0 or not torch.equal(got, want):
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version ({what}): max_abs_err {err}")
            log(f"kernel {name} ({what}): equal to plain on every lane")

    out = {}
    for name, parts in cases.items():
        stats = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                 "bound_ms": 0.0, "bound_by": "operations",
                 "library_ms": None, "parts": []}
        for kernel, plain, pick, what, (b_ms, b_by), timed, *extra in parts:
            got = kernel()
            want = plain()
            torch.cuda.synchronize()
            if pick is not None:
                got = got[..., pick].contiguous()
            err = max_abs_err(got, want)
            if err != 0.0 or not torch.equal(got, want):
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version ({what}): max_abs_err {err}")
            ms = cuda_ms(timed or kernel, 5)
            launch = extra[0]() if extra else {}    # of the timed launches
            plain_ms = cuda_ms(plain, 1, warm_up=False)    # it just ran
            log(f"kernel {name} ({what}): equal to plain; {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
            stats["ms"] += ms
            stats["plain_ms"] += plain_ms
            stats["bound_ms"] += b_ms
            stats["parts"].append({"what": what, "ms": ms,
                                   "plain_ms": plain_ms, "bound_ms": b_ms,
                                   "bound_by": b_by, **launch})
        stats["bound_by"] = max(stats["parts"],
                                key=lambda p: p["bound_ms"])["bound_by"]
        out[name] = stats
    return out


def tiled_fields(path, shape, size):
    """The fixture's fields as uint64 arrays, tiled up to `size` lanes."""
    return tile_fields(witness.u64_fields(witness.npz_leaves(path), shape),
                       size)


def _copy(fields):
    return {k: (None if v is None else [x.copy() for x in v]
                if isinstance(v, list) else v.copy())
            for k, v in fields.items()}


def _bump(arr, index):
    arr[index] = np.uint64((int(arr[index]) + 1) % gl.P)


def tamper(fields):
    """Corrupt one value in lanes 1..9 (lane 0 stays clean); returns the
    tampered fields and the lanes expected to fail."""
    f = _copy(fields)
    f["pow_witness"][1] ^= np.uint64(1)
    _bump(f["trace_cap"], (2, 0, 0))
    _bump(f["local_values"], (3, 0, 0))
    _bump(f["public_inputs"], (4, f["public_inputs"].shape[1] - 1))
    _bump(f["initial_evals"][0], (5, 10, 1))
    bad = [1, 2, 3, 4, 5]
    if f["step_evals"]:
        _bump(f["step_evals"][0], (6, 5, 3, 0))
        _bump(f["commit_caps"][0], (7, 1, 0))
        bad += [6, 7]
    _bump(f["final_poly"], (8, 0, 0))
    f["next_values"][9, 0, 0] = np.uint64(gl.P)   # not canonical
    bad += [8, 9]
    return f, bad


def tamper_bn254(fields):
    """The BN254 variant, lanes 1..7 (inside the CPU comparison): a cap word
    and a sibling word bumped, a cap element raised by p (>= p, the same
    residue), plus the Goldilocks surfaces."""
    f = _copy(fields)
    f["pow_witness"][1] ^= np.uint64(1)
    f["trace_cap"][2, 0, 0] += np.uint64(1)
    f["initial_siblings"][0][3, 5, 0, 0] += np.uint64(1)
    words = f["quotient_cap"][4, 1]
    v = sum(int(w) << (64 * k) for k, w in enumerate(words)) + fr.P
    f["quotient_cap"][4, 1] = [(v >> (64 * k)) & ((1 << 64) - 1)
                               for k in range(4)]
    _bump(f["initial_evals"][0], (5, 10, 1))
    if f["step_evals"]:
        _bump(f["step_evals"][0], (6, 5, 3, 0))
        f["commit_caps"][0][7, 1, 0] += np.uint64(1)
    else:
        _bump(f["public_inputs"], (6, 2))
        _bump(f["final_poly"], (7, 0, 0))
    return f, [1, 2, 3, 4, 5, 6, 7]


def counted(name, run, expected, absent=()):
    """run() with every kernel's launch count set to 0 just before it;
    returns (the counts just after it, run()'s result).  Raises if a kernel
    of `expected` never launched or one of `absent` did."""
    for w in WRAPPERS.values():
        w.launches = 0
    result = run()
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in WRAPPERS.items()}
    for k in expected:
        if counts[k] < 1:
            raise AssertionError(f"{name}: kernel {k} never launched")
    for k in absent:
        if counts[k] != 0:
            raise AssertionError(f"{name}: kernel {k} launched {counts[k]} "
                                 f"times")
    return counts, result


def drive_batch(name, verify, make_batch, fields, size, expected, tamper_fn,
                lanes, device_line):
    """Verify `make_batch(fields, device)` on the card (every lane must
    pass, the kernels of `expected` launch and K4-K9 outside it do not),
    time it best of 3, then verify a copy tampered by `tamper_fn`, whose
    first `lanes` lanes are also verified on the CPU; returns the kernel
    launch counts of the first run and its best wall time."""
    batch = make_batch(fields, DEVICE)
    counts, verdict = counted(
        name, lambda: verify(batch), expected,
        absent=[k for k in ("K4", "K5", "K6", "K7", "K8", "K9")
                if k not in expected])
    if verdict.shape != (size,) or not bool(verdict.all()):
        raise AssertionError(f"{name}: valid proofs rejected: "
                             f"{int((~verdict).sum())} of {size}")
    log(f"{name}: {size} valid proofs verified; launches {counts}")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        verify(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    log(f"{name}: {size / best:.1f} proofs/s ({best * 1e3:.2f} ms per batch "
        f"of {size}, best of 3) on {device_line}")

    bad_fields, bad = tamper_fn(fields)
    got = verify(make_batch(bad_fields, DEVICE)).cpu()
    want = torch.ones(size, dtype=torch.bool)
    want[bad] = False
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: tampered verdicts {got[:16].tolist()}, "
                             f"expected {want[:16].tolist()}")
    cpu = verify(make_batch(tile_fields(bad_fields, lanes), "cpu"))
    if not torch.equal(cpu, got[:lanes]):
        raise AssertionError(f"{name}: card and CPU verdicts differ: "
                             f"{got[:lanes].tolist()} vs {cpu.tolist()}")
    log(f"{name}: tampered lanes {bad} rejected, lane 0 and the rest "
        f"accepted; first {lanes} lanes equal the CPU plain path")
    return counts, best


def drive(name, num_rows, degree_bits, fixture, size, hasher, transcript_,
          expected, tamper_fn, lanes, device_line):
    """A FibonacciStark batch through `build_verifier` (`drive_batch`)."""
    fib, config, shape = fibonacci_shape(num_rows, degree_bits, hasher)
    fields = tiled_fields(os.path.join(FIXTURES, fixture), shape, size)
    verify = build_verifier(fib, config, degree_bits, hasher=hasher,
                            transcript=transcript_)
    return drive_batch(
        name, verify, lambda f, dev: witness.batch_from_u64(f, shape, dev),
        fields, size, expected, tamper_fn, lanes, device_line)


DRIVES = (
    # name, n, degree_bits, fixture, B, hasher, transcript, kernels launched,
    # tamper, lanes checked on the CPU (the plain BN254 permutation is slow)
    ("GL n=2^11 B=1024", 2048, 11, "fib_stark_n2048_x32.npz", 1024, GLH, GLH,
     ("K1", "K2", "K3"), tamper, 32),
    ("GL n=2^5 B=4096", 32, 5, "fib_stark_n32_x32.npz", 4096, GLH, GLH,
     ("K1", "K2"), tamper, 32),
    ("BN254 n=2^11 B=1024", 2048, 11, "fib_stark_n2048_poseidon_bn254_x8.npz",
     1024, BN, GLH, ("K2", "K4", "K5"), tamper_bn254, 8),
    ("BN254 n=2^5 B=4096", 32, 5, "fib_stark_n32_poseidon_bn254_x32.npz",
     4096, BN, GLH, ("K2", "K4", "K5"), tamper_bn254, 8),
    ("all-BN254 n=2^5 B=4096", 32, 5,
     "fib_stark_n32_poseidon_bn254_bn254sponge_x8.npz", 4096, BN, BN,
     ("K4", "K5", "K6"), tamper_bn254, 8),
)


def tamper_plonk(fields):
    """Corrupt one value in each of lanes 1..5, and 6 where the circuit has
    lookups (lane 0 stays clean): a public input, a wire opening, a Merkle
    sibling, a quotient opening, a Z opening made non-canonical, a lookup Z
    opening.  Returns the tampered fields and the lanes expected to fail."""
    f = _copy(fields)
    _bump(f["public_inputs"], (1, 0))
    _bump(f["wires"], (2, 3, 0))
    f["initial_siblings"][2][3, 1, 0] = np.uint64(9)
    _bump(f["quotient_polys"], (4, 0, 0))
    f["plonk_zs"][5, 0, 1] = np.uint64(gl.P)       # not canonical
    bad = [1, 2, 3, 4, 5]
    if f["lookup_zs"] is not None:
        _bump(f["lookup_zs"], (6, 0, 0))
        bad.append(6)
    return f, bad


def drive_plonk(name, circuit, size, lanes, device_line):
    """PLONK proofs read from JSON through `build_plonk_verifier`
    (`drive_batch`, tampered by `tamper_plonk`)."""
    common, vd, shape, fields = plonk_fields(circuit, size)
    return drive_batch(
        name, plonk.build_plonk_verifier(common, vd),
        lambda f, dev: plonk.plonk_batch_from_u64(f, shape, dev), fields,
        size, ("K1", "K2", "K3", "K7"), tamper_plonk, lanes, device_line)


PLONK_DRIVES = (
    # name, circuit, B, lanes checked on the CPU
    (f"PLONK recmix s60 B={PLONK_B}", RECMIX, PLONK_B, 8),
    ("PLONK recursive_fib_n8 B=256", RECURSIVE_FIB, 256, 8),
    ("PLONK logUp B=16", LOGUP, 16, 16),
)


PLONKISH_DRIVES = (
    # name, num_rows, degree_bits, proofs file, B, lanes checked on the CPU
    ("plonkish n=2^11 B=1024", 2048, 11, "plonkish_n2048_x8.jsonl", 1024, 32),
    ("plonkish n=2^5 B=4096", 32, 5, "plonkish_n32_x8.jsonl", 4096, 32),
)


def plonkish_fields(num_rows, degree_bits, proofs_file, size):
    """PlonkishStark proofs read from JSON: (stark, config, shape, fields
    tiled to `size` lanes)."""
    stark_ = PlonkishStark(num_rows)
    config = StarkConfig.standard_fast_config()
    shape = proof_shape(stark_, config, degree_bits)
    proofs = proof_json.read_jsonl(os.path.join(FIXTURES, proofs_file),
                                   proof_json.proof_from_json)
    return (stark_, config, shape,
            tile_fields(witness.proof_u64_fields(proofs, shape), size))


def drive_plonkish(name, num_rows, degree_bits, proofs_file, size, lanes,
                   device_line):
    """PlonkishStark proofs read from JSON, tiled to the batch, through
    `build_verifier` (`drive_batch`, tampered by `tamper`): K1, K2 and K3
    (the 7-wide trace oracle's leaves, at n=2^11 also the folds' 32-wide
    step leaves) launch, K4-K9 do not."""
    stark_, config, shape, fields = plonkish_fields(num_rows, degree_bits,
                                                    proofs_file, size)
    return drive_batch(
        name, build_verifier(stark_, config, degree_bits),
        lambda f, dev: witness.batch_from_u64(f, shape, dev), fields, size,
        ("K1", "K2", "K3"), tamper, lanes, device_line)


def spec_request(rid, spec):
    """A service request of the lanes of `spec` (as `parallel/dryrun.py:
    world_verdicts` takes it): its proofs' JSON dicts, tampered lanes
    included."""
    return {"id": rid, "stark": {"family": spec["family"],
                                 "num_rows": spec["num_rows"]},
            "hasher": spec.get("hasher", GLH),
            "format": spec.get("format", "native"),
            "proofs": lane_docs(spec, range(spec["size"]),
                                fixtures.read_docs(spec["fixture"]))}


# the serve drive's requests: (id, the lanes as `tiled_batch` builds them)
SERVE_REQUESTS = (
    ("fibonacci n=32 GL native", {
        "fixture": "fib_stark_n32_x8.jsonl", "family": "fibonacci",
        "num_rows": 32, "size": 3, "tampers": {"1": "public_input"}}),
    ("plonkish n=2^11 GL native B=1024", {
        "fixture": "plonkish_n2048_x8.jsonl", "family": "plonkish",
        "num_rows": 2048, "size": 1024,
        "tampers": {"1": "public_input", "2": "pow_witness",
                    "3": "quotient_opening", "700": "late_sibling"}}),
    ("plonkish n=32 GL plonky2 serde", {
        "fixture": "plonkish_n32_x4_plonky2.jsonl", "format": "plonky2",
        "family": "plonkish", "num_rows": 32, "size": 4,
        "tampers": {"1": "public_input", "3": "late_sibling"}}),
    ("fibonacci n=32 BN254 caps", {
        "fixture": "fib_stark_n32_poseidon_bn254_x8.jsonl",
        "family": "fibonacci", "num_rows": 32, "size": 3, "hasher": BN,
        "tampers": {"2": "public_input"}}),
)


def drive_serve(device_line):
    """A `serve.VerifierService` on the card answers a JSONL stream: the
    four SERVE_REQUESTS, a malformed line, and the first request again.
    Every verdict must equal the direct `build_verifier` verdict on the
    same lanes, the tampered lanes rejected; the repeat must find its
    verifier built (compile_s null); the malformed line gets an error
    while the service goes on.  K1-K5 launch, K6-K9 do not.  Returns the
    launch counts, the stream's wall time and the responses."""
    reqs = [spec_request(rid, spec) for rid, spec in SERVE_REQUESTS]
    lines = [json.dumps(r) for r in reqs]
    stream = "\n".join(lines[:1] + ['{"bad json'] + lines[1:] + lines[:1])
    svc = serve.VerifierService(DEVICE)
    out = io.StringIO()
    t0 = time.perf_counter()
    counts, _ = counted("serve", lambda: svc.run(io.StringIO(stream), out),
                        ("K1", "K2", "K3", "K4", "K5"),
                        absent=("K6", "K7", "K8", "K9"))
    wall = time.perf_counter() - t0
    resp = [json.loads(line) for line in out.getvalue().splitlines()]
    if len(resp) != 6 or set(resp[1]) != {"error"}:
        raise AssertionError(f"serve: responses {resp}")
    answers = [resp[0]] + resp[2:]
    for (rid, spec), r in zip(SERVE_REQUESTS + SERVE_REQUESTS[:1], answers):
        stark_, config, degree_bits, batch = tiled_batch(
            {**spec, "device": DEVICE})
        want = build_verifier(stark_, config, degree_bits,
                              hasher=spec.get("hasher", GLH))(batch).tolist()
        bad = sorted(int(k) for k in spec["tampers"])
        if want != [lane not in bad for lane in range(spec["size"])]:
            raise AssertionError(f"serve {rid}: direct verdicts reject "
                                 f"other lanes than {bad}")
        if r.get("id") != rid or r["verdicts"] != want:
            raise AssertionError(f"serve {rid}: {r.get('verdicts')} differ "
                                 f"from the direct verdicts")
        log(f"serve {rid}: batch {r['batch']}, compile_s {r['compile_s']}, "
            f"verify_ms {r['verify_ms']}; lanes {bad} rejected as by "
            f"build_verifier, on {device_line}")
    if answers[-1]["compile_s"] is not None:
        raise AssertionError(f"serve: the repeated request rebuilt: "
                             f"{answers[-1]}")
    log(f"serve: {len(resp)} responses in {wall:.2f} s; the malformed line "
        f"answered {resp[1]['error']!r}; launches {counts}")
    return counts, wall, answers


# the one-rank sharded and the unsharded verify are timed this many times
# each, in turns
SHARDED_TURNS = 8

SHARDED_SPEC = {
    "fixture": "fib_stark_n2048_x8.jsonl", "family": "fibonacci",
    "num_rows": 2048, "size": 1024, "device": DEVICE, "backend": "gloo",
    # lanes 5 and 700: a Merkle sibling of query 60, which only the second
    # of two query shards verifies
    "tampers": {"1": "public_input", "2": "pow_witness",
                "3": "quotient_opening", "5": "late_sibling",
                "700": "late_sibling"},
    "meshes": [[1, 2], [2, 1]]}


def drive_sharded(device_line):
    """Sharded verification on the card.  A one-rank NCCL world in this
    process runs `sharded_verifier` on the GL n=2^11 B=1024 batch of the
    first drive, tampered by `tamper`, and must give the unsharded
    verify's verdicts (both timed, SHARDED_TURNS times each, in turns).
    Then a world of 2 processes on the same card (gloo: NCCL refuses two
    ranks on one card) verifies SHARDED_SPEC under dp=1 qp=2 and dp=2
    qp=1, each rank loading only its dp slice; the gathered verdicts must
    equal the unsharded verify's, lanes 5 and 700 rejected.  Returns the
    launch counts and walls of both."""
    fib, config, shape = fibonacci_shape(2048, 11)
    fields = tiled_fields(os.path.join(FIXTURES, "fib_stark_n2048_x32.npz"),
                          shape, 1024)
    bad_fields, bad = tamper(fields)
    batch = witness.batch_from_u64(bad_fields, shape, DEVICE)
    unsharded = build_verifier(fib, config, 11)
    want = unsharded(batch)
    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize(f"file://{tmp}/rendezvous", 1, 0)
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"sharded: backend {dist.get_backend()}")
            mesh = make_mesh()
            verify = sharded_verifier(fib, config, 11, mesh)
            local = shard_batch(batch, mesh)
            counts, got = counted("sharded 1 rank", lambda: verify(local),
                                  ("K1", "K2", "K3"),
                                  absent=("K4", "K5", "K6", "K7", "K8", "K9"))
            if not torch.equal(got, want):
                raise AssertionError("sharded 1 rank: verdicts differ from "
                                     "the unsharded verify's")
            walls = {"sharded": [], "unsharded": []}
            for _ in range(SHARDED_TURNS):
                for tag, fn in (("sharded", lambda: verify(local)),
                                ("unsharded", lambda: unsharded(batch))):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls[tag].append(time.perf_counter() - t0)
        finally:
            dist.destroy_process_group()
    one = {k: [t * 1e3 for t in v] for k, v in walls.items()}
    log(f"sharded 1 rank (NCCL): verdicts equal the unsharded verify's "
        f"(lanes {bad} rejected); {SHARDED_TURNS} turns of sharded, "
        f"unsharded, ms: " + ", ".join(
            f"{a:.2f} {b:.2f}" for a, b in zip(one["sharded"],
                                              one["unsharded"]))
        + f"; medians {statistics.median(one['sharded']):.2f} sharded, "
        f"{statistics.median(one['unsharded']):.2f} unsharded, on "
        f"{device_line}; launches {counts}")

    _, _, _, b2 = tiled_batch(SHARDED_SPEC)
    want2 = unsharded(b2).tolist()
    bad2 = sorted(int(k) for k in SHARDED_SPEC["tampers"])
    if want2 != [lane not in bad2 for lane in range(1024)]:
        raise AssertionError(f"sharded: unsharded verdicts reject other "
                             f"lanes than {bad2}")
    t0 = time.perf_counter()
    runs = world_verdicts(SHARDED_SPEC, 2, 600)
    world_wall = time.perf_counter() - t0
    if [(r["dp"], r["qp"]) for r in runs] != [(1, 2), (2, 1)]:
        raise AssertionError(f"sharded 2 ranks: runs {runs}")
    for r in runs:
        if r["verdicts"] != want2:
            raise AssertionError(f"sharded 2 ranks dp={r['dp']} qp="
                                 f"{r['qp']}: verdicts differ from the "
                                 f"unsharded verify's")
        log(f"sharded 2 ranks (gloo, one card) dp={r['dp']} qp={r['qp']}: "
            f"verdicts equal the unsharded verify's, lanes {bad2} rejected; "
            f"rank 0 verify {r['wall_ms']:.2f} ms, launches {r['launches']}")
    counts2 = {k: sum(r["launches"].get(k, 0) for r in runs)
               for k in WRAPPERS}
    log(f"sharded 2 ranks: the world took {world_wall:.2f} s with its start")
    return counts, min(walls["sharded"]), counts2, world_wall, {
        "one_rank_ms": one,
        "two_ranks_verify_ms": {f"dp={r['dp']} qp={r['qp']}": r["wall_ms"]
                                for r in runs}}


def drive_bulk_hash(rng, device_line, lanes=1 << 17, cpu_lanes=64):
    """The batch-last bulk hashing API of `ops/poseidon.py` on `lanes`
    seeded lanes on the card (K7), each call's first `cpu_lanes` lanes held
    against the plain path on the CPU; returns the launch counts and the
    best wall time of the whole set of calls."""
    left, right = rand_gl(rng, (lanes, 4)), rand_gl(rng, (lanes, 4))
    calls = [("permute", pos.permute, (rand_gl(rng, (lanes, 12)),), 12)]
    calls += [(f"hash_no_pad k={k}", pos.hash_no_pad,
               (rand_gl(rng, (lanes, k)),), 4) for k in (8, 13, 60)]
    calls += [("two_to_one", pos.two_to_one, (left, right), 4)]
    args = [[gl.from_u64(a, DEVICE) for a in c[2]] for c in calls]

    def run():
        return [fn(*a) for (_, fn, _, _), a in zip(calls, args)]

    counts, outs = counted("GL bulk hash", run, ("K7",))
    for (what, fn, host, width), out in zip(calls, outs):
        if out.shape != (lanes, width):
            raise AssertionError(f"GL bulk hash {what}: shape {out.shape}")
        cpu = fn(*(gl.from_u64(a[:cpu_lanes]) for a in host))
        if not torch.equal(out[:cpu_lanes].cpu(), cpu):
            raise AssertionError(f"GL bulk hash {what}: the card and the CPU "
                                 f"plain path differ")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    per_call = ", ".join(
        f"{what} {cuda_ms(lambda fn=fn, a=a: fn(*a), 3):.4f} ms"
        for (what, fn, _, _), a in zip(calls, args))
    log(f"GL bulk hash: {lanes} lanes, first {cpu_lanes} equal the CPU plain "
        f"path; launches {counts}; {min(times) * 1e3:.2f} ms for all, best "
        f"of 3 (per call, CUDA events: {per_call}) on {device_line}")
    return counts, min(times)


def drive_sol():
    """`measure_poseidon_sol` (K7, K8, K1) and `measure_gl_mul_sol` (K10,
    8 x 2^21 elements, chain 256) on the card; returns the launch counts,
    the wall time, the probes' rows and the gl_mul row."""
    t0 = time.perf_counter()

    def run():
        return (torch_sol_bench.measure_poseidon_sol(device=DEVICE, log=log),
                torch_sol_bench.measure_gl_mul_sol(device=DEVICE))

    counts, ((pps, _, rows), (rate, sec)) = counted(
        "SOL probes", run, ("K7", "K8", "K1", "K10"))
    if not all(math.isfinite(r["perm_per_sec"]) and r["perm_per_sec"] > 0
               for r in rows) or not (math.isfinite(rate) and rate > 0):
        raise AssertionError(f"SOL probes: rates {rows}, gl_mul {rate}")
    b_ms, b_by = bound(*gl_mul_chain(8 << 21, 256))
    mul = {"gl_mul_per_sec": rate, "ms_per_rep": sec * 1e3,
           "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / (sec * 1e3)}
    log(f"SOL probes: best {pps / 1e6:.2f} M perm/s; gl_mul (K10, 8 x 2^21, "
        f"chain 256) {rate / 1e9:.3f} G mul/s, {sec * 1e3:.4f} ms/rep, bound "
        f"{b_ms:.4f} ms ({b_by}), share {mul['share']:.4f}; launches "
        f"{counts}")
    return counts, time.perf_counter() - t0, rows, mul


# the census drive: (anchor, kernels launched, (verify, one-proof batch on
# the card))
def _census_cases():
    def fib(num_rows, degree_bits, fixture):
        f, config, shape = fibonacci_shape(num_rows, degree_bits)
        leaves = witness.npz_leaves(os.path.join(FIXTURES, fixture))
        return (build_verifier(f, config, degree_bits),
                witness.batch_from_numpy([x[:1] for x in leaves], shape,
                                         DEVICE))

    def recmix():
        common, vd, shape, fields = plonk_fields(RECMIX, 1)
        return (plonk.build_plonk_verifier(common, vd),
                plonk.plonk_batch_from_u64(fields, shape, DEVICE))

    return (("gl_n2048", ("K1", "K2", "K3"),
             lambda: fib(2048, 11, "fib_stark_n2048_x32.npz")),
            ("gl_n32", ("K1", "K2"),
             lambda: fib(32, 5, "fib_stark_n32_x32.npz")),
            ("plonk_recmix_s60", ("K1", "K2", "K3", "K7"), recmix))


def drive_census():
    """`profiling.profile_verifier` of one proof on the card, the kernels
    running: GL n=2^11, GL n=2^5 and the PLONK recmix circuit.  Each total
    must equal its `CENSUS_ANCHORS` entry.  Returns the launch counts, the
    wall time and {anchor: totals}."""
    t0 = time.perf_counter()
    out, all_counts = {}, {}
    for name, expected, make in _census_cases():
        verify, batch = make()

        def run():
            with profiling.profile() as tree:
                ok = verify(batch)
            return ok, tree

        counts, (ok, tree) = counted(f"census {name}", run, expected)
        if not bool(ok.all()):
            raise AssertionError(f"census {name}: the proof was rejected")
        want = CENSUS_ANCHORS[name]
        got = {m: tree.root.total(m) for m in want}
        if got != want:
            raise AssertionError(f"census {name}: {got}, anchor {want}")
        scopes = {c.name: c.total("gl_mul")
                  for c in tree.root.children.values()}
        log(f"census {name}: {got} equal to the anchor; gl_mul by scope "
            f"{scopes}; launches {counts}")
        out[name] = got
        for k, v in counts.items():
            all_counts[k] = all_counts.get(k, 0) + v
    return all_counts, time.perf_counter() - t0, out


def drive_bn254_micro(checked):
    """`tools/torch_bn254_micro.py:measure` on the card (K9); returns the
    launch counts, the wall time and the probes' rows and summary, each
    row's time also as a ratio to its time in the kernel check (`checked`:
    K9's parts from `check_kernels`), which the two must share."""
    t0 = time.perf_counter()
    counts, (rows, summary) = counted(
        "BN254 component probes",
        lambda: torch_bn254_micro.measure(device=DEVICE, log=log), ("K9",))
    if not all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows):
        raise AssertionError(f"BN254 component probes: times {rows}")
    check_ms = {(p["probe"], p["threads"], p["k"]): p["ms"] for p in checked}
    for r in rows:
        r["over_check"] = r["ms"] / check_ms[r["probe"], r["threads"], r["k"]]
    worst = max(rows, key=lambda r: abs(r["over_check"] - 1))
    log(f"BN254 component probes: launches {counts}; drive / check time "
        f"{min(r['over_check'] for r in rows):.3f}-"
        f"{max(r['over_check'] for r in rows):.3f} (furthest: "
        f"{worst['probe']} threads {worst['threads']} k {worst['k']})")
    return counts, time.perf_counter() - t0, {"runs": rows,
                                              "summary": summary}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this test needs a CUDA card")

    t_start = time.monotonic()

    # 1. the device
    kind = torch.cuda.get_device_name(0)
    device_line = torch_sol_bench.card_line()
    log(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(device_line)

    # 2. build
    t0 = time.monotonic()
    built = _build.build_all()
    log(f"build: {time.monotonic() - t0:.1f} s for {sorted(built)}")
    for name, text in sorted(_build.build_log.items()):
        for line in text.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"ptxas {name}: {line.strip()}")

    # 3. each kernel against its plain version
    rng = np.random.default_rng(SEED)
    kstats = check_kernels(rng)

    # 4. the drives
    counts, walls = {}, {}
    for name, *spec in DRIVES:
        counts[name], walls[name] = drive(name, *spec, device_line)
    for name, *spec in PLONK_DRIVES:
        counts[name], walls[name] = drive_plonk(name, *spec, device_line)
    for name, *spec in PLONKISH_DRIVES:
        counts[name], walls[name] = drive_plonkish(name, *spec, device_line)
    counts["serve"], walls["serve"], serve_resp = drive_serve(device_line)
    (counts["sharded 1 rank"], walls["sharded 1 rank"],
     counts["sharded 2 ranks (rank 0)"], walls["sharded 2 ranks (rank 0)"],
     sharded_ms) = drive_sharded(device_line)
    counts["GL bulk hash"], walls["GL bulk hash"] = drive_bulk_hash(
        rng, device_line)
    counts["census"], walls["census"], census = drive_census()
    counts["SOL probes"], walls["SOL probes"], sol_rows, mul_sol = drive_sol()
    (counts["BN254 component probes"], walls["BN254 component probes"],
     micro_rows) = drive_bn254_micro(kstats["K9"]["parts"])

    # BASELINE.json's second metric, the port's figures: census gl_mul per
    # proof x the GL drives' proofs/s, over K10's gl_mul rate
    speed_of_light = {}
    for anchor, drive_name, size in (("gl_n2048", "GL n=2^11 B=1024", 1024),
                                     ("gl_n32", "GL n=2^5 B=4096", 4096)):
        per_proof = census[anchor]["gl_mul"]
        rate = per_proof * size / walls[drive_name]
        speed_of_light[drive_name] = {
            "gl_mul_per_proof": per_proof, "proofs_per_sec":
            size / walls[drive_name], "gl_mul_per_sec": rate,
            "pct_speed_of_light": 100 * rate / mul_sol["gl_mul_per_sec"]}
    log("gl_mul speed of light: " + json.dumps(
        {"sol_gl_mul_per_sec": mul_sol["gl_mul_per_sec"],
         "drives": speed_of_light, "card": device_line}))

    # 5. the kernels line, then the contract's last line
    src = "halo2_plonky2_verifier_tpu_torch/ops/csrc/"
    pallas = "halo2_plonky2_verifier_tpu/ops/"
    meta = {
        "K1": ("merkle_path", "merkle_path.cu",
               pallas + "merkle_pallas.py:39"),
        "K2": ("transcript", "transcript.cu",
               pallas + "transcript_pallas.py:37"),
        "K3": ("leaf_sponge", "leaf_sponge.cu",
               pallas + "merkle_pallas.py:159"),
        "K4": ("bn254_path", "bn254_path.cu",
               pallas + "poseidon_bn254_pallas.py:518"),
        "K5": ("bn254_leaf", "bn254_leaf.cu",
               pallas + "poseidon_bn254_pallas.py:422"),
        "K6": ("bn254_permute", "bn254_permute.cu",
               pallas + "poseidon_bn254_pallas.py:412"),
        "K7": ("permute", "permute.cu", pallas + "poseidon_pallas.py:293"),
        "K8": ("permute_chained", "permute_chained.cu",
               pallas + "poseidon_pallas.py:368"),
        "K9": ("bn254_micro", "bn254_micro.cu", "tools/bn254_micro.py:45"),
        # no Pallas counterpart: the JAX probe is an XLA-fused lax.scan
        "K10": ("gl_mul_chain", "gl_mul_chain.cu", "tools/sol_bench.py:23"),
    }
    log(f"chip_smoke: {time.monotonic() - t_start:.1f} s from the start")
    kernels = []
    for k, (name, source, replaces) in meta.items():
        by_drive = {d: counts[d][k] for d in counts}
        kernels.append({
            "name": f"{k} {name}", "route": "cuda", "source": src + source,
            "replaces": replaces,
            "launches": sum(by_drive.values()), "launches_by_drive": by_drive,
            "matched": True, **kstats[k]})
    print(json.dumps({"kernels": kernels, "card": device_line,
                      "sol_probes": sol_rows, "gl_mul_sol": mul_sol,
                      "gl_mul_speed_of_light": speed_of_light,
                      "census": census, "bn254_probes": micro_rows,
                      "serve": [{k: r[k] for k in ("id", "batch",
                                                   "compile_s", "verify_ms")}
                                for r in serve_resp],
                      "sharded_ms": sharded_ms,
                      "wall_ms": {d: w * 1e3 for d, w in walls.items()}}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

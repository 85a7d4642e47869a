"""The PyTorch port's transcript: the plain version of kernel K2 against the
JAX package's Pallas transcript kernel (interpret mode, groups=1), and the
port's challenges against the frozen anchors of tests/fixtures/
golden_anchors.json.

Integer results: the tolerance is 0.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from halo2_plonky2_verifier_tpu import load_proofs
from halo2_plonky2_verifier_tpu import proof_shape as jax_proof_shape
from halo2_plonky2_verifier_tpu.ops import goldilocks as jgl
from halo2_plonky2_verifier_tpu.ops import transcript_pallas
from halo2_plonky2_verifier_tpu.refimpl.fixtures import get_fibonacci_proof
from halo2_plonky2_verifier_tpu_torch import batch_from_numpy, proof_shape
from halo2_plonky2_verifier_tpu_torch import transcript as ttr
from halo2_plonky2_verifier_tpu_torch.models.fibonacci import FibonacciStark
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks as tgl
from halo2_plonky2_verifier_tpu_torch.ops import transcript_kernels as tk
from halo2_plonky2_verifier_tpu_torch.stark import challenge_stream
from halo2_plonky2_verifier_tpu_torch.utils.config import StarkConfig

ANCHORS = os.path.join(os.path.dirname(__file__), "fixtures",
                       "golden_anchors.json")
P = tgl.P


def test_run_steps_plain_vs_pallas_interpret():
    rng = np.random.default_rng(3)
    n_steps, b = 5, 8
    chunks = rng.integers(0, P, size=(n_steps, 8, b), dtype=np.uint64)
    chunks.reshape(-1)[:2] = [0, P - 1]
    mask = np.ones((n_steps, 8), dtype=np.uint32)
    mask[1, 3:] = 0                     # partial chunk
    mask[2, :] = 0                      # bare permute
    mask[4, ::2] = 0
    want = transcript_pallas.run_steps_planes(
        jgl.from_u64(chunks), jnp.asarray(mask[:, :, None]), interpret=True,
        groups=1)
    got = tk.run_steps_planes_plain(tgl.from_u64(chunks),
                                    torch.from_numpy(mask.astype(np.int32)))
    np.testing.assert_array_equal(tgl.to_u64(got), jgl.to_u64(want))


def test_run_steps_wrapper_uses_plain_on_cpu():
    chunks = tgl.from_u64(np.arange(2 * 8 * 3, dtype=np.uint64).reshape(2, 8, 3))
    mask = torch.ones((2, 8), dtype=torch.int32)
    before = tk.run_steps_planes.launches
    assert torch.equal(tk.run_steps_planes(chunks, mask),
                       tk.run_steps_planes_plain(chunks, mask))
    assert tk.run_steps_planes.launches == before
    with pytest.raises(ValueError):
        tk.run_steps_planes(chunks, mask[:1])


def _gl_anchors():
    with open(ANCHORS) as f:
        return [a for a in json.load(f)["anchors"]
                if a["hasher"] == "poseidon_goldilocks"]


@pytest.mark.parametrize("anchor", _gl_anchors(),
                         ids=lambda a: f"n{a['num_rows']}")
def test_challenges_match_frozen_anchors(anchor):
    n = anchor["num_rows"]
    _, config, pwp = get_fibonacci_proof(n)
    degree_bits = pwp.proof.recover_degree_bits(config)
    stark = FibonacciStark(n)
    jax_batch = load_proofs([pwp], jax_proof_shape(stark, config, degree_bits))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_batch)]
    batch = batch_from_numpy(
        leaves, proof_shape(stark, StarkConfig.standard_fast_config(),
                            degree_bits), "cpu")

    sched, elements, refs = challenge_stream(batch)
    ys = ttr.run_schedule(sched, elements)

    def val(ref):
        return str(int(tgl.to_u64(ttr.extract(ys, ref))[0]))

    def ext(pair):
        return [val(pair[0]), val(pair[1])]

    assert [val(r) for r in refs["alphas"]] == anchor["stark_alphas"]
    assert ext(refs["zeta"]) == anchor["stark_zeta"]
    assert ext(refs["fri_alpha"]) == anchor["fri_alpha"]
    assert [ext(r) for r in refs["betas"]] == anchor["fri_betas"]
    assert val(refs["pow"]) == anchor["fri_pow_response"]
    assert [val(r) for r in refs["queries"][:8]] == \
        anchor["fri_query_indices_first8"]
    assert [[[val(b), val(g)] for (b, g) in cset] for cset in refs["perm"]] \
        == anchor["permutation_challenges"]
    assert len(anchor["fri_betas"]) == len(batch.shape.reduction_arity_bits)


def test_schedule_copy_matches_jax_schedule():
    """The copied TranscriptSchedule replays the same observe/draw sequence
    into the same steps and challenge coordinates."""
    from halo2_plonky2_verifier_tpu.transcript import TranscriptSchedule

    ops = [("o", 64), ("c", 4), ("o", 64), ("c", 2), ("o", 13), ("c", 2),
           ("c", 9), ("o", 1), ("c", 30)]
    scheds = [TranscriptSchedule(), ttr.TranscriptSchedule()]
    draws = [[], []]
    for s, d in zip(scheds, draws):
        for kind, k in ops:
            if kind == "o":
                s.observe(k)
            else:
                d.extend((r.step, r.lane) for r in s.get_n_challenges(k))
    assert scheds[0].steps == scheds[1].steps
    assert draws[0] == draws[1]

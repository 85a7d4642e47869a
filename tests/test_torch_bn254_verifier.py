"""The PyTorch port's BN254 configurations on the CPU (the plain versions of
kernels K2, K4, K5 and K6): the loader against the JAX loader, the BN254
transcript against the JAX schedule, refimpl's BN254 challenger and the
frozen n=8 anchor, and whole verifications of both BN254 configurations --
fixture lanes, and tampered proofs whose verdicts equal refimpl's.

The JAX verifier itself is never compiled here.  Integer results: the
tolerance is 0.
"""

import copy
import json
import os
import random

import jax
import numpy as np
import pytest
import torch

from halo2_plonky2_verifier_tpu import load_proofs
from halo2_plonky2_verifier_tpu import proof_shape as jax_proof_shape
from halo2_plonky2_verifier_tpu import transcript as jtr
from halo2_plonky2_verifier_tpu import witness as jwit
from halo2_plonky2_verifier_tpu.models.fibonacci import \
    FibonacciStark as JaxFibonacciStark
from halo2_plonky2_verifier_tpu.refimpl import field as gl_ref
from halo2_plonky2_verifier_tpu.refimpl import hashers, prover, verifier
from halo2_plonky2_verifier_tpu.refimpl.challenger import BN254Challenger
from halo2_plonky2_verifier_tpu.refimpl.fixtures import (
    fibonacci_public_inputs, get_fibonacci_proof)
from halo2_plonky2_verifier_tpu.utils.config import FriConfig as JaxFriConfig
from halo2_plonky2_verifier_tpu.utils.config import \
    StarkConfig as JaxStarkConfig
from halo2_plonky2_verifier_tpu_torch import (batch_from_numpy, build_verifier,
                                              proof_shape, witness)
from halo2_plonky2_verifier_tpu_torch import transcript as ttr
from halo2_plonky2_verifier_tpu_torch.models.fibonacci import FibonacciStark
from halo2_plonky2_verifier_tpu_torch.ops import bn254 as fr
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks as tgl
from halo2_plonky2_verifier_tpu_torch.stark import challenge_stream
from halo2_plonky2_verifier_tpu_torch.utils.config import FriConfig, StarkConfig

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
BN = "poseidon_bn254"
GL_P = gl_ref.P
CONFIG = StarkConfig.standard_fast_config()


def _small_configs():
    """The all-BN254 test config of tests/test_bn254_sponge_e2e.py (arity-4
    folds, 4 queries), for the JAX package and for the port."""
    kw = dict(rate_bits=1, cap_height=1, proof_of_work_bits=8,
              reduction_strategy=(2, 1), num_query_rounds=4)
    return (JaxStarkConfig(num_challenges=2, fri_config=JaxFriConfig(**kw)),
            StarkConfig(num_challenges=2, fri_config=FriConfig(**kw)))


def _leaves(jax_batch):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_batch)]


def _port_batch(proofs, num_rows, jax_config, config):
    """refimpl proofs -> JAX load_proofs -> the port's batch (CPU)."""
    db = proofs[0].proof.recover_degree_bits(jax_config)
    jshape = jax_proof_shape(JaxFibonacciStark(num_rows), jax_config, db, BN)
    shape = proof_shape(FibonacciStark(num_rows), config, db, BN)
    return batch_from_numpy(_leaves(load_proofs(proofs, jshape)), shape,
                            "cpu"), db


def _npz_batch(name, num_rows, degree_bits, lanes):
    """The first `lanes` lanes of a BN254 columnar fixture."""
    shape = proof_shape(FibonacciStark(num_rows), CONFIG, degree_bits, BN)
    f = witness.u64_fields(witness.npz_leaves(os.path.join(FIXTURES, name)),
                           shape)
    f = {k: (None if v is None else [x[:lanes] for x in v]
             if isinstance(v, list) else v[:lanes]) for k, v in f.items()}
    return witness.batch_from_u64(f, shape, "cpu")


# ----------------------------------------------------------------------------
# the loader
# ----------------------------------------------------------------------------

def _assert_batch_equals_jax(batch, jax_batch):
    """Goldilocks fields as (hi, lo) pairs, BN254 hashes as 16-bit limbs."""
    for f in witness._FIELDS:
        mine, want = getattr(batch, f), getattr(jax_batch, f)
        if want is None:
            assert mine is None, f
            continue
        pairs = zip(mine, want) if isinstance(want, list) else [(mine, want)]
        for a, b in pairs:
            if f in witness.HASH_FIELDS:
                limbs = np.asarray(b)
                vals = np.array(fr.to_ints(a), dtype=object)
                ref = sum(limbs[..., k].astype(object) << (16 * k)
                          for k in range(16))
                assert a.shape == limbs.shape[:-1] + (4,), f
                assert (vals == ref).all(), f
            else:
                hi, lo = (np.asarray(x).astype(np.uint64) for x in b)
                np.testing.assert_array_equal(
                    tgl.to_u64(a), (hi << np.uint64(32)) | lo, f)


def test_batch_from_numpy_matches_load_proofs():
    stark, config, pwp = get_fibonacci_proof(8, hasher=hashers.BN254)
    proofs = [pwp, copy.deepcopy(pwp)]
    proofs[1].proof.trace_cap[0] = fr.P + 7          # non-canonical survives
    db = pwp.proof.recover_degree_bits(config)
    jax_batch = load_proofs(proofs, jax_proof_shape(stark, config, db, BN))
    batch = batch_from_numpy(_leaves(jax_batch),
                             proof_shape(FibonacciStark(8), CONFIG, db, BN),
                             "cpu")
    assert batch.batch_size == 2
    _assert_batch_equals_jax(batch, jax_batch)


def test_load_npz_matches_jax_loader():
    name = "fib_stark_n32_poseidon_bn254_x16.npz"
    stark, config, pwp = get_fibonacci_proof(32, hasher=hashers.BN254)
    jshape = jax_proof_shape(stark, config, 5, BN)
    jax_batch = jwit.load_batch_npz(os.path.join(FIXTURES, name),
                                    load_proofs([pwp], jshape))
    batch = witness.load_batch_npz(os.path.join(FIXTURES, name),
                                   proof_shape(FibonacciStark(32), CONFIG, 5,
                                               BN), "cpu")
    assert batch.batch_size == 16
    _assert_batch_equals_jax(batch, jax_batch)


# ----------------------------------------------------------------------------
# the BN254 transcript
# ----------------------------------------------------------------------------

def _script(seed, n_ops=12):
    rng = random.Random(seed)
    ops = []
    for _ in range(n_ops):
        if rng.random() < 0.55:
            ops.append(("o", rng.choice([1, 2, 3, 4, 7, 9, 10, 23])))
        else:
            ops.append(("c", rng.choice([1, 2, 3, 16])))
    return ops + [("c", 2)]


def _replay(sched, ops):
    refs = []
    for kind, k in ops:
        if kind == "o":
            sched.observe(k)
        else:
            refs.extend(sched.get_n_challenges(k))
    return refs


def test_bn254_schedule_copy_matches_jax():
    ops = _script(7, 20)
    mine, want = ttr.BN254TranscriptSchedule(), jtr.BN254TranscriptSchedule()
    r0, r1 = _replay(mine, ops), _replay(want, ops)
    assert mine.steps == want.steps
    assert [(r.step, r.lane) for r in r0] == [(r.step, r.lane) for r in r1]


@pytest.mark.parametrize("seed", [7, 11])
def test_run_schedule_bn254_vs_refimpl_challenger(seed):
    """Partial chunks, multi-permute absorbs and bare-permute squeezes; the
    draws equal refimpl's BN254Challenger lane by lane."""
    ops = _script(seed) if seed == 7 else [("o", 23), ("c", 1), ("o", 4),
                                           ("c", 18)]
    sched = ttr.BN254TranscriptSchedule()
    refs = _replay(sched, ops)
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, GL_P, size=(2, sched.n_elements), dtype=np.uint64)
    ys = ttr.run_schedule_bn254(sched, tgl.from_u64(vals))
    for b in range(2):
        ch = BN254Challenger()
        it = iter(int(x) for x in vals[b])
        want = []
        for kind, k in ops:
            if kind == "o":
                ch.observe_elements([next(it) for _ in range(k)])
            else:
                want.extend(ch.get_n_challenges(k))
        got = [int(tgl.to_u64(ttr.extract(ys, r))[b]) for r in refs]
        assert got == want


def test_gl_transcript_bn254_hasher_challenges_match_frozen_anchor():
    with open(os.path.join(FIXTURES, "golden_anchors.json")) as f:
        anchor = [a for a in json.load(f)["anchors"]
                  if a["hasher"] == BN and a["num_rows"] == 8][0]
    _, config, pwp = get_fibonacci_proof(8, hasher=hashers.BN254)
    batch, _ = _port_batch([pwp], 8, config, CONFIG)
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
    if "permutation_challenges" in anchor:
        assert [[[val(b), val(g)] for (b, g) in cset]
                for cset in refs["perm"]] == anchor["permutation_challenges"]


# ----------------------------------------------------------------------------
# whole verifications
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name,num_rows,degree_bits,lanes,transcript", [
    ("fib_stark_n32_poseidon_bn254_x16.npz", 32, 5, 3, "poseidon_goldilocks"),
    ("fib_stark_n2048_poseidon_bn254_x8.npz", 2048, 11, 2,
     "poseidon_goldilocks"),
    ("fib_stark_n32_poseidon_bn254_bn254sponge_x8.npz", 32, 5, 2, BN),
])
def test_verifier_accepts_bn254_fixture_lanes(name, num_rows, degree_bits,
                                              lanes, transcript):
    batch = _npz_batch(name, num_rows, degree_bits, lanes)
    verify = build_verifier(FibonacciStark(num_rows), CONFIG, degree_bits,
                            hasher=BN, transcript=transcript)
    verdict = verify(batch)
    assert verdict.dtype == torch.bool and verdict.tolist() == [True] * lanes


def _refimpl_accepts(pwp, config, transcript):
    try:
        verifier.verify(FibonacciStark(8), pwp, config, hasher=hashers.BN254,
                        transcript=transcript)
    except verifier.VerificationError:
        return False
    return True


@pytest.mark.parametrize("transcript", ["poseidon_goldilocks", BN])
def test_tampering_like_refimpl(transcript):
    """n=8 proofs of the small config of tests/test_bn254_sponge_e2e.py
    (trees of depth 2, two arity-4 folds), made here in well under a
    second.  Lane 0 is clean; every other lane has one bump: a cap word (the
    transcript observes it), an initial-tree sibling, a leaf value, a
    commit-phase cap, a fold-step sibling, the PoW witness, an opening.
    The port's verdicts equal refimpl's."""
    jcfg, cfg = _small_configs()
    stark = JaxFibonacciStark(8)
    pis = fibonacci_public_inputs(8)
    trace = stark.generate_trace(pis[0], pis[1], GL_P)
    pwp = prover.prove(stark, jcfg, trace, pis, hashers.BN254,
                       transcript=transcript)
    proofs = [copy.deepcopy(pwp) for _ in range(8)]

    def qr(i, q):
        return proofs[i].proof.opening_proof.query_round_proofs[q]

    def bump_fr(seq, k):
        seq[k] = (seq[k] + 1) % fr.P

    bump_fr(proofs[1].proof.trace_cap, 0)
    bump_fr(qr(2, 1).initial_trees_proof.evals_proofs[1][1].siblings, 0)
    leaf = qr(3, 2).initial_trees_proof.evals_proofs[0][0]
    leaf[1] = (leaf[1] + 1) % GL_P
    bump_fr(proofs[4].proof.opening_proof.commit_phase_merkle_caps[0], 1)
    bump_fr(qr(5, 3).steps[0].merkle_proof.siblings, 0)
    proofs[6].proof.opening_proof.pow_witness = (
        proofs[6].proof.opening_proof.pow_witness + 1) % GL_P
    lv = proofs[7].proof.openings.local_values
    lv[0] = ((lv[0][0] + 1) % GL_P, lv[0][1])
    want = [_refimpl_accepts(p, jcfg, transcript) for p in proofs]
    assert want == [True] + [False] * 7
    batch, db = _port_batch(proofs, 8, jcfg, cfg)
    got = build_verifier(FibonacciStark(8), cfg, db, hasher=BN,
                         transcript=transcript)(batch)
    assert got.tolist() == want


def test_noncanonical_bn254_cap_word_rejected():
    """A cap element >= p_bn254 fails the range check, though its 56-bit
    limbs would be observed without complaint."""
    _, config, pwp = get_fibonacci_proof(8, hasher=hashers.BN254)
    proofs = [copy.deepcopy(pwp) for _ in range(3)]
    proofs[1].proof.quotient_polys_cap[1] += fr.P      # same residue, >= p
    batch, db = _port_batch(proofs, 8, config, CONFIG)
    assert not bool(fr.is_canonical(batch.quotient_cap[1, 1]))
    got = build_verifier(FibonacciStark(8), CONFIG, db, hasher=BN)(batch)
    assert got.tolist() == [True, False, True]

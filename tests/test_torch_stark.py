"""The PyTorch port's proof batches and whole verifier, on the CPU (the plain
versions of every kernel): the loaders against the JAX package's, the copied
pure-Python pieces against their originals, verdicts on the fixture batches,
tampered proofs against what refimpl.verifier.verify says, and the port
running in a process that cannot import jax.

The JAX verifier itself is never compiled here.  Integer results: the
tolerance is 0.
"""

import copy
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from halo2_plonky2_verifier_tpu import load_proofs
from halo2_plonky2_verifier_tpu import proof_shape as jax_proof_shape
from halo2_plonky2_verifier_tpu import witness as jwit
from halo2_plonky2_verifier_tpu.models.fibonacci import \
    FibonacciStark as JaxFibonacciStark
from halo2_plonky2_verifier_tpu.refimpl import prover as ref_prover
from halo2_plonky2_verifier_tpu.refimpl import verifier as ref_verifier
from halo2_plonky2_verifier_tpu.refimpl.fixtures import (
    get_fibonacci_proof, get_fibonacci_proof_batch)
from halo2_plonky2_verifier_tpu.utils.config import \
    StarkConfig as JaxStarkConfig
from halo2_plonky2_verifier_tpu_torch import (batch_from_numpy, build_verifier,
                                              load_batch_npz, proof_shape,
                                              witness)
from halo2_plonky2_verifier_tpu_torch import stark as tstark
from halo2_plonky2_verifier_tpu_torch.models.fibonacci import FibonacciStark
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks as tgl
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks_ext as tgle
from halo2_plonky2_verifier_tpu_torch.utils.config import StarkConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
P = tgl.P
CONFIG = StarkConfig.standard_fast_config()
DEGREE_BITS = {8: 3, 32: 5, 128: 7, 2048: 11}

_VERIFIERS = {}


def _port_verifier(num_rows):
    if num_rows not in _VERIFIERS:
        _VERIFIERS[num_rows] = build_verifier(
            FibonacciStark(num_rows), CONFIG, DEGREE_BITS[num_rows])
    return _VERIFIERS[num_rows]


def _shapes(num_rows):
    db = DEGREE_BITS[num_rows]
    return (proof_shape(FibonacciStark(num_rows), CONFIG, db),
            jax_proof_shape(JaxFibonacciStark(num_rows),
                            JaxStarkConfig.standard_fast_config(), db))


def _jax_u64(pair):
    """A JAX (hi, lo) uint32 pair -> uint64 numpy array."""
    hi, lo = (np.asarray(x).astype(np.uint64) for x in pair)
    return (hi << np.uint64(32)) | lo


def _assert_batch_equals_jax(batch, jax_batch):
    for f in witness._FIELDS:
        mine, ref = getattr(batch, f), getattr(jax_batch, f)
        if ref is None:
            assert mine is None, f
            continue
        if isinstance(ref, list):
            assert len(mine) == len(ref), f
            for a, b in zip(mine, ref):
                np.testing.assert_array_equal(tgl.to_u64(a), _jax_u64(b), f)
        else:
            np.testing.assert_array_equal(tgl.to_u64(mine), _jax_u64(ref), f)


def _leaves(jax_batch):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_batch)]


# ----------------------------------------------------------------------------
# the copied pure-Python pieces
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("degree_bits", [3, 5, 7, 11, 13])
def test_proof_shape_copy_matches_jax(degree_bits):
    mine = proof_shape(FibonacciStark(1 << degree_bits), CONFIG, degree_bits)
    ref = jax_proof_shape(JaxFibonacciStark(1 << degree_bits),
                          JaxStarkConfig.standard_fast_config(), degree_bits)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.step_depths == ref.step_depths
    assert mine.oracle_widths == ref.oracle_widths


class _IntF:
    """Field ops over host ints mod p, for running Stark.eval on numbers."""

    def one(self):
        return 1

    def add(self, a, b):
        return (a + b) % P

    def sub(self, a, b):
        return (a - b) % P

    def mul(self, a, b):
        return a * b % P

    def from_base(self, x):
        return x


class _Recorder:
    def __init__(self):
        self.out = []

    def constraint(self, c):
        self.out.append(("all", c))

    def constraint_transition(self, c):
        self.out.append(("transition", c))

    def constraint_first_row(self, c):
        self.out.append(("first", c))

    def constraint_last_row(self, c):
        self.out.append(("last", c))


def test_fibonacci_and_permutation_copies_match_originals():
    """The copied FibonacciStark.eval, get_permutation_batches and
    eval_permutation_checks emit the same constraints, in the same order, as
    the JAX package's model and refimpl/prover.py."""
    rng = np.random.default_rng(5)
    local, nxt, zs, zs_next, pis = (
        [int(v) for v in rng.integers(0, P, size=k, dtype=np.uint64)]
        for k in (4, 4, 2, 2, 3))
    sets = [[tuple(int(v) for v in rng.integers(0, P, size=2, dtype=np.uint64))
             for _ in range(2)]]
    outs = []
    for stark, batches_fn, checks_fn in (
            (FibonacciStark(8), tstark.get_permutation_batches,
             tstark.eval_permutation_checks),
            (JaxFibonacciStark(8), ref_prover.get_permutation_batches,
             ref_prover.eval_permutation_checks)):
        rec = _Recorder()
        stark.eval(_IntF(), local, nxt, pis, rec)
        batches = batches_fn(stark.permutation_pairs(), sets, 2,
                             stark.permutation_batch_size())
        checks_fn(_IntF(), local, zs, zs_next, batches, rec)
        outs.append((rec.out, stark.constraint_degree(),
                     [p.column_pairs for p in stark.permutation_pairs()]))
    assert outs[0] == outs[1]


def test_ext_ops_stacked_forms_equal_loops():
    """ExtOps.mul_elems / mul_many (one stacked multiply) and fold equal the
    element-by-element loops they stand for."""
    rng = np.random.default_rng(9)
    F = tstark.ExtOps((5,), "cpu")

    def ext():
        return tuple(tgl.from_u64(rng.integers(0, P, size=5, dtype=np.uint64))
                     for _ in range(2))

    def same(u, v):
        assert torch.equal(u[0], v[0]) and torch.equal(u[1], v[1])

    a, xs, ys = ext(), [ext() for _ in range(4)], [ext() for _ in range(4)]
    for got, x, y in zip(F.mul_elems(xs, ys), xs, ys):
        same(got, tgle.mul(x, y))
    for got, x in zip(F.mul_many(a, xs), xs):
        same(got, tgle.mul(a, x))
    assert F.mul_elems([], []) == [] and F.mul_many(a, []) == []

    def body(c, x):
        return F.add(c, x), F.mul(c, x)

    carry, outs = F.fold(body, F.one(), xs)
    c = F.one()
    for x, got in zip(xs, outs):
        same(got, tgle.mul(c, x))
        c = tgle.add(c, x)
    same(carry, c)


# ----------------------------------------------------------------------------
# state carried across: proof batches
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("num_rows", [32, 2048])
def test_load_batch_npz_matches_jax_loader(num_rows):
    shape, jshape = _shapes(num_rows)
    path = os.path.join(FIXTURES, f"fib_stark_n{num_rows}_x8.npz")
    _, _, pwp = get_fibonacci_proof(num_rows)
    jax_batch = jwit.load_batch_npz(path, load_proofs([pwp], jshape))
    batch = load_batch_npz(path, shape, "cpu")
    assert batch.batch_size == 8
    _assert_batch_equals_jax(batch, jax_batch)


@pytest.mark.parametrize("num_rows", [32, 2048])
def test_batch_from_numpy_matches_load_proofs(num_rows):
    shape, jshape = _shapes(num_rows)
    _, _, proofs = get_fibonacci_proof_batch(num_rows, 8)
    jax_batch = load_proofs(proofs[:3], jshape)
    batch = batch_from_numpy(_leaves(jax_batch), shape, "cpu")
    assert batch.batch_size == 3
    _assert_batch_equals_jax(batch, jax_batch)


def test_batch_from_numpy_rejects_wrong_leaf_count():
    shape, jshape = _shapes(32)
    _, _, pwp = get_fibonacci_proof(32)
    leaves = _leaves(load_proofs([pwp], jshape))
    with pytest.raises(ValueError):
        batch_from_numpy(leaves[:-2], shape, "cpu")
    with pytest.raises(ValueError):
        batch_from_numpy(leaves + leaves[:2], shape, "cpu")


# ----------------------------------------------------------------------------
# the verifier, plain path
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("num_rows", [32, 2048])
def test_verifier_accepts_fixture_batches(num_rows):
    shape, _ = _shapes(num_rows)
    batch = load_batch_npz(
        os.path.join(FIXTURES, f"fib_stark_n{num_rows}_x8.npz"), shape, "cpu")
    verdict = _port_verifier(num_rows)(batch)
    assert verdict.dtype == torch.bool and verdict.shape == (8,)
    assert verdict.all()


def _refimpl_accepts(num_rows, pwp):
    try:
        ref_verifier.verify(FibonacciStark(num_rows), pwp, CONFIG)
    except ref_verifier.VerificationError:
        return False
    return True


def _port_verdicts(num_rows, proofs):
    shape, jshape = _shapes(num_rows)
    batch = batch_from_numpy(_leaves(load_proofs(proofs, jshape)), shape, "cpu")
    return _port_verifier(num_rows)(batch).tolist()


def test_verifier_rejects_tampering_like_refimpl():
    """The tampers of the JAX verifier's tests at n=8: lane 0 clean, every
    other lane corrupted once.  The port's verdicts equal refimpl's."""
    _, _, pwp = get_fibonacci_proof(8)
    proofs = [copy.deepcopy(pwp) for _ in range(6)]
    proofs[1].proof.opening_proof.pow_witness ^= 1
    proofs[2].proof.trace_cap[0][0] = (proofs[2].proof.trace_cap[0][0] + 1) % P
    lv = proofs[3].proof.openings.local_values
    lv[0] = ((lv[0][0] + 1) % P, lv[0][1])
    proofs[4].public_inputs[2] = (proofs[4].public_inputs[2] + 1) % P
    ev = proofs[5].proof.opening_proof.query_round_proofs[10].initial_trees_proof
    ev.evals_proofs[0][0][1] = (ev.evals_proofs[0][0][1] + 1) % P
    want = [_refimpl_accepts(8, p) for p in proofs]
    assert want == [True] + [False] * 5
    assert _port_verdicts(8, proofs) == want


def test_verifier_rejects_noncanonical_witness():
    """A value >= p fails the range check (refimpl takes ints and has none)."""
    _, _, pwp = get_fibonacci_proof(8)
    proofs = [copy.deepcopy(pwp) for _ in range(3)]
    proofs[1].proof.openings.next_values[0] = (P, 0)
    assert _port_verdicts(8, proofs) == [True, False, True]


def test_verifier_rejects_fold_tampering_like_refimpl():
    """The FRI-fold tampers of the JAX verifier's tests, at n=128 (one
    arity-16 fold, step leaves through the leaf sponge)."""
    _, _, pwp = get_fibonacci_proof(128)
    proofs = [copy.deepcopy(pwp) for _ in range(4)]
    st = proofs[1].proof.opening_proof.query_round_proofs[5].steps[0]
    st.evals[3] = ((st.evals[3][0] + 1) % P, st.evals[3][1])
    proofs[2].proof.opening_proof.commit_phase_merkle_caps[0][1][0] ^= 1
    fp = proofs[3].proof.opening_proof.final_poly
    fp[0] = ((fp[0][0] + 1) % P, fp[0][1])
    want = [_refimpl_accepts(128, p) for p in proofs]
    assert want == [True, False, False, False]
    assert _port_verdicts(128, proofs) == want


@pytest.mark.parametrize("backend", ["hasher", "transcript"])
def test_build_verifier_rejects_unported_backends(backend):
    """Both BN254 backends build (alone and together); an unknown hasher or
    transcript name still raises."""
    for kw in ({backend: "poseidon_bn254"},
               {"hasher": "poseidon_bn254", "transcript": "poseidon_bn254"}):
        assert callable(build_verifier(FibonacciStark(8), CONFIG, 3, **kw))
    with pytest.raises(ValueError):
        build_verifier(FibonacciStark(8), CONFIG, 3, **{backend: "sha256"})


_NO_JAX = textwrap.dedent("""
    import sys

    BLOCKED = ("jax", "jaxlib", "halo2_plonky2_verifier_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("import of " + name + " is blocked")
            return None

    for m in list(sys.modules):
        if m.split(".")[0] in BLOCKED:
            del sys.modules[m]
    sys.meta_path.insert(0, Block())
    sys.path.insert(0, sys.argv[1])

    from halo2_plonky2_verifier_tpu_torch import (StarkConfig, build_verifier,
                                                  load_batch_npz, proof_shape,
                                                  witness)
    from halo2_plonky2_verifier_tpu_torch.models.fibonacci import FibonacciStark

    stark, config = FibonacciStark(32), StarkConfig.standard_fast_config()
    batch = load_batch_npz(sys.argv[2], proof_shape(stark, config, 5), "cpu")
    verdict = build_verifier(stark, config, 5)(batch)
    assert verdict.tolist() == [True] * 8, verdict

    # the all-BN254 configuration: BN254 caps and the BN254 transcript
    shape = proof_shape(stark, config, 5, "poseidon_bn254")
    fields = witness.u64_fields(witness.npz_leaves(sys.argv[3]), shape)
    fields = {k: (None if v is None else [x[:2] for x in v]
                  if isinstance(v, list) else v[:2]) for k, v in fields.items()}
    verdict = build_verifier(stark, config, 5, hasher="poseidon_bn254",
                             transcript="poseidon_bn254")(
        witness.batch_from_u64(fields, shape, "cpu"))
    assert verdict.tolist() == [True] * 2, verdict

    # PLONK: the circuit from its fixture, one recmix proof from JSON (the
    # repo's format and plonky2's serde readers both import)
    from halo2_plonky2_verifier_tpu_torch import interop, plonk, proof_json
    from halo2_plonky2_verifier_tpu_torch.circuit import load_circuit

    common, vd, _ = load_circuit(sys.argv[4])
    with open(sys.argv[5]) as f:
        proof = proof_json.plonk_proof_from_json(f.readline())
    shape = plonk.plonk_proof_shape(common)
    verdict = plonk.build_plonk_verifier(common, vd)(
        plonk.load_plonk_proofs([proof], shape, vd, "cpu"))
    assert verdict.tolist() == [True], verdict
    assert callable(interop.plonk_proof_from_plonky2_json)
    loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not loaded, loaded
    print("verified without jax")
""")


def test_port_verifies_in_a_process_without_jax():
    """The card's machine has no jax: the port must import and verify a
    Goldilocks and an all-BN254 batch, and a PLONK proof read from JSON
    against its circuit fixture, with every import of jax (and of the JAX
    package) refused."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX, REPO,
         os.path.join(FIXTURES, "fib_stark_n32_x8.npz"),
         os.path.join(FIXTURES,
                      "fib_stark_n32_poseidon_bn254_bn254sponge_x8.npz"),
         os.path.join(FIXTURES, "plonk_circuit_recmix_s60.json"),
         os.path.join(FIXTURES, "plonk_recmix_s60_x4.jsonl")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        # one torch thread: beside other test processes a full thread pool
        # contends for the same cores and runs many times slower
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-4000:]
    assert "verified without jax" in out.stdout

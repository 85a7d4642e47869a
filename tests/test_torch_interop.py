"""The PyTorch port's proof ingestion from JSON, on the CPU: the repo's own
JSON (`proof_json.py`) and plonky2's serde JSON (`interop.py`) against the
npz path and the JAX package's readers and loaders, bit for bit.

The serde documents are written inside the tests by the JAX package's
`interop.py` writers.  A BN254 hash has no serde form in the reference (its
`HashOut` holds 4 Goldilocks elements), so the BN254 fixture is read from
the repo's JSON only.  Integer results: the tolerance is 0.
"""

import inspect
import json
import os

import numpy as np
import pytest
import torch

from halo2_plonky2_verifier_tpu import interop as jinterop
from halo2_plonky2_verifier_tpu import plonk as jplonk
from halo2_plonky2_verifier_tpu.refimpl.fixtures import get_plonk_proof_batch
from halo2_plonky2_verifier_tpu.refimpl.plonk import \
    plonk_proof_from_json as ref_plonk_from_json
from halo2_plonky2_verifier_tpu.refimpl.proof import \
    proof_from_json as ref_proof_from_json
from halo2_plonky2_verifier_tpu_torch import (StarkConfig, interop, plonk,
                                              proof_json, proof_shape,
                                              witness)
from halo2_plonky2_verifier_tpu_torch.circuit import load_circuit
from halo2_plonky2_verifier_tpu_torch.models.fibonacci import FibonacciStark

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")

# (JSON lines, the npz holding the same proofs first, rows, degree_bits,
# hasher)
STARK_FIXTURES = [
    ("fib_stark_n32_x8.jsonl", "fib_stark_n32_x8.npz", 32, 5,
     "poseidon_goldilocks"),
    ("fib_stark_n2048_x8.jsonl", "fib_stark_n2048_x8.npz", 2048, 11,
     "poseidon_goldilocks"),
    ("fib_stark_n32_poseidon_bn254_x8.jsonl",
     "fib_stark_n32_poseidon_bn254_x16.npz", 32, 5, "poseidon_bn254"),
]
GL_FIXTURES = [f for f in STARK_FIXTURES if f[4] == "poseidon_goldilocks"]


def _lines(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return [line for line in f if line.strip()]


def _shape(rows, degree_bits, hasher):
    return proof_shape(FibonacciStark(rows), StarkConfig(), degree_bits,
                       hasher)


def _npz_batch(name, shape, count):
    fields = witness.u64_fields(
        witness.npz_leaves(os.path.join(FIXTURES, name)), shape)
    fields = {k: (None if v is None else [x[:count] for x in v]
                  if isinstance(v, list) else v[:count])
              for k, v in fields.items()}
    return witness.batch_from_u64(fields, shape, "cpu")


def _assert_batches_equal(a, b, names):
    for f in names:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        xs, ys = (x, y) if isinstance(x, list) else ([x], [y])
        assert len(xs) == len(ys), f
        for u, v in zip(xs, ys):
            assert u.dtype == v.dtype == torch.int64, f
            assert torch.equal(u, v), f


@pytest.mark.parametrize("jsonl,npz,rows,degree_bits,hasher",
                         STARK_FIXTURES, ids=[f[0] for f in STARK_FIXTURES])
def test_load_proofs_from_json_equals_npz(jsonl, npz, rows, degree_bits,
                                          hasher):
    """JSON lines through the port's reader and `load_proofs` give the
    batch the npz path gives, field by field."""
    shape = _shape(rows, degree_bits, hasher)
    proofs = [proof_json.proof_from_json(s) for s in _lines(jsonl)]
    got = witness.load_proofs(proofs, shape, "cpu")
    _assert_batches_equal(got, _npz_batch(npz, shape, len(proofs)),
                          witness._FIELDS)


@pytest.mark.parametrize("jsonl,npz,rows,degree_bits,hasher", GL_FIXTURES,
                         ids=[f[0] for f in GL_FIXTURES])
def test_serde_stark_reader_equals_json_reader(jsonl, npz, rows, degree_bits,
                                               hasher):
    """plonky2 serde JSON written by the JAX package's writer reads back to
    the proof the repo's JSON reader gives, and loads to the npz batch."""
    lines = _lines(jsonl)
    serde = [jinterop.stark_proof_to_plonky2_json(ref_proof_from_json(s))
             for s in lines]
    got = [interop.stark_proof_from_plonky2_json(s) for s in serde]
    assert got == [proof_json.proof_from_json(s) for s in lines]
    shape = _shape(rows, degree_bits, hasher)
    _assert_batches_equal(witness.load_proofs(got, shape, "cpu"),
                          _npz_batch(npz, shape, len(got)), witness._FIELDS)


def _drop_opening(d):
    d["openings"]["local_values"].pop()


def _drop_query(d):
    d["opening_proof"]["query_round_proofs"].pop()


def _drop_public_input(d):
    d["public_inputs"].pop()


@pytest.mark.parametrize("spoil", [_drop_opening, _drop_query,
                                   _drop_public_input])
def test_load_proofs_refuses_a_proof_of_another_geometry(spoil):
    """A STARK proof whose counts are not the shape's is refused at load,
    with ValueError, not handed to the verifier."""
    shape = _shape(32, 5, "poseidon_goldilocks")
    bad = json.loads(_lines("fib_stark_n32_x8.jsonl")[0])
    spoil(bad)
    with pytest.raises(ValueError):
        witness.load_proofs([proof_json.proof_from_json(bad)],
                            shape, "cpu")


@pytest.mark.parametrize("tag", ["recmix_s60", "logup"])
def test_serde_plonk_reader_equals_json_reader(tag):
    """The same for PLONK proofs, lookup openings included (logUp)."""
    _, _, doc = load_circuit(os.path.join(FIXTURES,
                                          f"plonk_circuit_{tag}.json"))
    lines = _lines(doc["proofs"])[:2]
    serde = [jinterop.plonk_proof_to_plonky2_json(ref_plonk_from_json(s))
             for s in lines]
    got = [interop.plonk_proof_from_plonky2_json(s) for s in serde]
    assert got == [proof_json.plonk_proof_from_json(s) for s in lines]
    assert all(p.proof.openings.lookup_zs for p in got) == (tag == "logup")


def test_serde_plonk_reader_requires_the_openings():
    """A missing pre-lookup opening is a parse error, as in the reference."""
    line = _lines("plonk_recmix_s60_x4.jsonl")[0]
    doc = json.loads(jinterop.plonk_proof_to_plonky2_json(
        ref_plonk_from_json(line)))
    del doc["proof"]["openings"]["wires"]
    with pytest.raises(KeyError):
        interop.plonk_proof_from_plonky2_json(doc)


def test_load_plonk_proofs_equals_jax():
    """`plonk.load_plonk_proofs` on the recmix fixture equals the JAX
    package's `load_plonk_proofs`, array by array."""
    common, vd, _ = load_circuit(os.path.join(
        FIXTURES, "plonk_circuit_recmix_s60.json"))
    proofs = proof_json.read_jsonl(
        os.path.join(FIXTURES, "plonk_recmix_s60_x4.jsonl"),
        proof_json.plonk_proof_from_json)
    shape = plonk.plonk_proof_shape(common)
    got = plonk.load_plonk_proofs(proofs, shape, vd, "cpu")

    jcommon, jvd, jproofs = get_plonk_proof_batch(4)
    jshape = jplonk.plonk_proof_shape(jcommon, len(jproofs[0].public_inputs))
    assert dataclass_dict(jshape) == dataclass_dict(shape)
    want = jplonk.load_plonk_proofs(jproofs, jshape, jvd)
    for f in plonk.PLONK_FIELDS:
        x, y = getattr(got, f), getattr(want, f)
        if y is None:
            assert x is None, f
            continue
        xs, ys = (x, y) if isinstance(x, list) else ([x], [y])
        assert len(xs) == len(ys), f
        for u, (hi, lo) in zip(xs, ys):
            w = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
                 | np.asarray(lo).astype(np.uint64))
            np.testing.assert_array_equal(u.numpy().view(np.uint64), w,
                                          err_msg=f)


def dataclass_dict(shape):
    return {k: getattr(shape, k) for k in shape.__dataclass_fields__}


def test_loaders_refuse_values_out_of_range():
    """A Goldilocks value must fit 64 bits and a BN254 hash 256 bits; a
    value in [p, 2^64) loads and is left to the canonicality verdict."""
    with pytest.raises(OverflowError):
        witness.u64([[1 << 64]])
    with pytest.raises(ValueError):
        witness.bn254_words([1 << 256])
    words = witness.bn254_words([[(1 << 256) - 1, 5]])
    assert words.shape == (1, 2, 4) and words.dtype == np.uint64
    assert words[0, 0].tolist() == [(1 << 64) - 1] * 4
    assert words[0, 1].tolist() == [5, 0, 0, 0]


def test_loaders_default_to_the_card():
    """The loaders put a batch on the card unless the caller asks for the
    CPU, so a verify of what they return reaches the kernels."""
    for fn in (witness.load_proofs, plonk.load_plonk_proofs):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default).type == "cuda"

"""The port's proof writers against the JAX package's.

For every proof of every JSON and JSON-lines fixture, in the repo's format
and in plonky2's serde format: the port's reader then the port's writer
gives exactly the string the JAX writer gives on the JAX reader's object,
and the JAX reader reads the port's string back to an equal object.
`witness.save_batch_npz` of a batch loaded from an npz fixture writes the
fixture's arrays again, name for name, in dtype, shape and value.
"""

import json
import os

import numpy as np
import pytest
import torch

from halo2_plonky2_verifier_tpu import interop as jinterop
from halo2_plonky2_verifier_tpu.refimpl import proof as jproof
from halo2_plonky2_verifier_tpu.refimpl.plonk import proof as jplonk
from halo2_plonky2_verifier_tpu_torch import interop, proof_json, witness
from halo2_plonky2_verifier_tpu_torch.models.fibonacci import FibonacciStark
from halo2_plonky2_verifier_tpu_torch.utils.config import StarkConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def _kind(name):
    """The proof format of a fixture file, or None for a file of no
    proofs."""
    if not name.endswith((".json", ".jsonl")):
        return None
    if name.startswith(("plonk_circuit_", "golden_", "census_")) \
            or name.endswith("_verdicts.json"):
        return None
    if name.startswith(("plonk_", "recursive_fib_")):
        return "plonk"
    return "stark_plonky2" if name.endswith("_plonky2.jsonl") else "stark"


FILES = sorted(n for n in os.listdir(FIXTURES) if _kind(n))


def _lines(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return [line for line in f if line.strip()]


def test_every_proof_fixture_is_covered():
    kinds = {_kind(n) for n in FILES}
    assert kinds == {"stark", "stark_plonky2", "plonk"}
    assert len(FILES) >= 20


@pytest.mark.parametrize("name", FILES)
def test_writers_give_the_jax_strings(name):
    kind = _kind(name)
    for line in _lines(name):
        if kind == "stark":
            mine = proof_json.proof_from_json(line)
            ref = jproof.proof_from_json(line)
            out = proof_json.proof_to_json(mine)
            assert out == jproof.proof_to_json(ref)
            assert jproof.proof_from_json(out) == ref
            if isinstance(mine.proof.trace_cap[0], list):    # GL caps
                serde = interop.stark_proof_to_plonky2_json(mine)
                assert serde == jinterop.stark_proof_to_plonky2_json(ref)
                assert jinterop.stark_proof_from_plonky2_json(serde) == \
                    jinterop.stark_proof_from_plonky2_json(
                        jinterop.stark_proof_to_plonky2_json(ref))
            else:                   # BN254 caps: no serde form
                with pytest.raises(ValueError, match="BN254"):
                    interop.stark_proof_to_plonky2_json(mine)
                with pytest.raises(TypeError):
                    jinterop.stark_proof_to_plonky2_json(ref)
        elif kind == "stark_plonky2":
            mine = interop.stark_proof_from_plonky2_json(line)
            ref = jinterop.stark_proof_from_plonky2_json(line)
            out = interop.stark_proof_to_plonky2_json(mine)
            assert out == jinterop.stark_proof_to_plonky2_json(ref)
            assert jinterop.stark_proof_from_plonky2_json(out) == ref
            native = proof_json.proof_to_json(mine)
            assert native == jproof.proof_to_json(ref)
        else:
            mine = proof_json.plonk_proof_from_json(line)
            ref = jplonk.plonk_proof_from_json(line)
            out = proof_json.plonk_proof_to_json(mine)
            assert out == jplonk.plonk_proof_to_json(ref)
            assert jplonk.plonk_proof_from_json(out) == ref
            serde = interop.plonk_proof_to_plonky2_json(mine)
            assert serde == jinterop.plonk_proof_to_plonky2_json(ref)
            assert jinterop.plonk_proof_from_plonky2_json(serde) == ref
            assert interop.plonk_proof_from_plonky2_json(serde) == mine


def test_writers_keep_key_order_and_nulls():
    """A proof without permutation Zs writes null for them, in the JAX
    writer's key order."""
    line = _lines("fib_stark_n8.json")[0]
    out = json.loads(proof_json.proof_to_json(
        proof_json.proof_from_json(line)))
    assert list(out) == list(json.loads(jproof.proof_to_json(
        jproof.proof_from_json(line))))
    doc = json.loads(line)
    doc["permutation_zs_cap"] = None
    doc["openings"]["permutation_zs"] = None
    doc["openings"]["permutation_zs_next"] = None
    text = json.dumps(doc)
    out = proof_json.proof_to_json(proof_json.proof_from_json(text))
    assert out == jproof.proof_to_json(jproof.proof_from_json(text))
    assert '"permutation_zs_cap": null' in out


NPZ = [("fib_stark_n32_x8.npz", 32, 5, "poseidon_goldilocks"),
       ("fib_stark_n2048_x8.npz", 2048, 11, "poseidon_goldilocks"),
       ("fib_stark_n32_poseidon_bn254_x16.npz", 32, 5, "poseidon_bn254"),
       ("fib_stark_n32_poseidon_bn254_bn254sponge_x8.npz", 32, 5,
        "poseidon_bn254")]


@pytest.mark.parametrize("name,num_rows,degree_bits,hasher", NPZ)
def test_save_batch_npz_writes_the_fixture(tmp_path, name, num_rows,
                                           degree_bits, hasher):
    shape = witness.proof_shape(FibonacciStark(num_rows),
                                StarkConfig.standard_fast_config(),
                                degree_bits, hasher)
    path = os.path.join(FIXTURES, name)
    batch = witness.load_batch_npz(path, shape, "cpu")
    out = tmp_path / "batch.npz"
    witness.save_batch_npz(str(out), batch)
    with np.load(path) as want, np.load(out) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert np.array_equal(got[k], want[k]), k
    again = witness.load_batch_npz(str(out), shape, "cpu")
    assert torch.equal(again.pow_witness, batch.pow_witness)


def test_save_batch_npz_of_proofs_read_from_json(tmp_path):
    """A batch loaded from JSON proofs writes the leaves the JAX loader and
    writer give for the same proofs."""
    from halo2_plonky2_verifier_tpu import load_proofs as jload
    from halo2_plonky2_verifier_tpu import proof_shape as jshape
    from halo2_plonky2_verifier_tpu.models.fibonacci import \
        FibonacciStark as JFib
    from halo2_plonky2_verifier_tpu.utils.config import \
        StarkConfig as JConfig
    from halo2_plonky2_verifier_tpu.witness import save_batch_npz as jsave

    lines = _lines("fib_stark_n32_poseidon_bn254_x8.jsonl")[:2]
    shape = witness.proof_shape(FibonacciStark(32),
                                StarkConfig.standard_fast_config(), 5,
                                "poseidon_bn254")
    batch = witness.load_proofs([proof_json.proof_from_json(x)
                                 for x in lines], shape, "cpu")
    witness.save_batch_npz(str(tmp_path / "port.npz"), batch)
    jbatch = jload([jproof.proof_from_json(x) for x in lines],
                   jshape(JFib(32), JConfig.standard_fast_config(), 5,
                          "poseidon_bn254"))
    jsave(str(tmp_path / "jax.npz"), jbatch)
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k

"""The reference: its hashes against known answers, the fixtures' verdicts,
every tamper kind rejected, and agreement with the program's plain CPU
path as the harness drives it."""

import numpy as np
import pytest

from verifier_bench import harness, proofs, traffic
from verifier_bench.reference import (constants, geometry, gl_numpy,
                                      poseidon_bn254, verifier)


def _load(config, rows):
    cfg = harness.read_json(harness.part("configs", config))
    geom = geometry.geometry(cfg, rows)
    return geom, proofs.load(harness.HERE.parent / cfg["proofs"][str(rows)],
                             geom)


def test_goldilocks_poseidon_known_answer():
    out = gl_numpy.permute(np.zeros((3, 12), dtype=np.uint64))
    assert [int(x) for x in out[1]] == constants.KAT_ZERO_STATE


def test_goldilocks_mds_against_python_ints():
    rng = np.random.default_rng(3)
    s = rng.integers(0, 2 ** 63, size=(64, 12), dtype=np.uint64) * \
        np.uint64(2) % gl_numpy.P
    s[0] = gl_numpy.P_INT - 1            # the largest canonical values
    got = gl_numpy.mds(s)
    for row, want_row in zip(got, s):
        v = [int(x) for x in want_row]
        want = [sum((constants.MDS_MATRIX_CIRC[(c - r) % 12]
                     + (constants.MDS_MATRIX_DIAG[r] if r == c else 0)) * v[c]
                    for c in range(12)) % gl_numpy.P_INT for r in range(12)]
        assert [int(x) for x in row] == want


def test_bn254_poseidon_known_answer():
    # circomlib's poseidon([1, 2, 3]): t = 4, capacity 0
    assert poseidon_bn254.permute([0, 1, 2, 3])[0] == \
        constants.KAT_T4_HASH_1_2_3


@pytest.mark.parametrize("config,rows,lanes", [("starky_fib_gl", 32, 32),
                                               ("starky_fib_gl", 2048, 4),
                                               ("starky_fib_bn254caps", 2048,
                                                2)])
def test_fixture_proofs_verify(config, rows, lanes):
    geom, fields = _load(config, rows)
    ok = verifier.verify_lanes(geom, proofs.select(fields, np.arange(lanes)))
    assert ok.all()


@pytest.mark.parametrize("config,rows", [("starky_fib_gl", 32),
                                         ("starky_fib_gl", 2048),
                                         ("starky_fib_bn254caps", 2048)])
def test_every_tamper_kind_rejected(config, rows):
    geom, fields = _load(config, rows)
    one = proofs.select(fields, np.arange(1))
    kinds = traffic.kinds_for(geom)
    plan = traffic.make_plan(11, {"batch": 2 * len(kinds),
                                  "tampered_lanes": len(kinds),
                                  "batches_cycled": 1}, geom, one)
    lanes = traffic.reference_lanes(plan, one)
    ok = verifier.verify_lanes(geom, lanes)
    assert ok[0]
    rejected = {k for (_, k, _), v in zip(plan[0]["tampers"], ok[1:])
                if not v}
    assert rejected == set(kinds)


def test_range_check_rejects_an_alias():
    geom, fields = _load("starky_fib_gl", 32)
    f = proofs.select(fields, np.arange(2))
    v = int(f["local_values"][1, 0, 0])
    if v + gl_numpy.P_INT < 1 << 64:     # the alias v + p, same residue
        f["local_values"][1, 0, 0] = np.uint64(v + gl_numpy.P_INT)
    else:
        f["local_values"][1, 0, 0] = gl_numpy.P
    assert verifier.verify_lanes(geom, f).tolist() == [True, False]
    r = constants.P_BN254
    words = np.array([((r - 1) >> (64 * k)) & (2 ** 64 - 1) for k in range(4)],
                     dtype=np.uint64)
    assert verifier.bn254_below_modulus(words)
    words[0] += np.uint64(1)             # exactly the modulus
    assert not verifier.bn254_below_modulus(words)


def test_agrees_with_the_program_plain_path():
    """A whole run on the CPU: the program's plain path on every lane of
    the window, the reference on every distinct and tampered lane."""
    result, compared = harness.run_cell(
        "fib_gl.n32.bulk", 2 ** 35 + 3, 0.01, False, device="cpu",
        overrides={"batch": 12, "tampered_lanes": 9, "batches_cycled": 2})
    assert result["correct"], compared
    assert result["attempted"] >= 12 and result["failed"] == 0


@pytest.mark.card
def test_a_short_run_on_the_card(card, root):
    import json
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "verifier_bench/run.py", "--workload",
         "fib_gl.n32.bulk", "--seed", "5", "--seconds", "3", "--trace", "0",
         "--batch", "4096"], cwd=root, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"]

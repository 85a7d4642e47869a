"""The traffic generator: seeded, every kind in every batch, the same
writes for the program and the reference."""

import json

import numpy as np
import pytest

from verifier_bench import harness, proofs, traffic
from verifier_bench.reference import geometry

SMALL = {"batch": 64, "tampered_lanes": 16, "batches_cycled": 4}


def _load(config, rows):
    cfg = harness.read_json(harness.part("configs", config))
    geom = geometry.geometry(cfg, rows)
    return geom, proofs.load(harness.HERE.parent / cfg["proofs"][str(rows)],
                             geom)


def _plan_key(plan):
    return json.dumps([[b["sources"].tolist(), b["tampers"]] for b in plan])


@pytest.mark.parametrize("config,rows", [("starky_fib_gl", 32),
                                         ("starky_fib_gl", 2048),
                                         ("starky_fib_bn254caps", 2048)])
def test_same_seed_same_lanes_and_tampers(config, rows):
    geom, fields = _load(config, rows)
    seed = 2 ** 33 + 17                 # wider than 32 signed bits
    a = traffic.make_plan(seed, SMALL, geom, fields)
    b = traffic.make_plan(seed, SMALL, geom, fields)
    c = traffic.make_plan(seed + 1, SMALL, geom, fields)
    assert _plan_key(a) == _plan_key(b)
    assert _plan_key(a) != _plan_key(c)
    for p in (a, c):
        for batch in p:
            kinds = [k for _, k, _ in batch["tampers"]]
            assert set(kinds) == set(traffic.kinds_for(geom))
            lanes = [lane for lane, _, _ in batch["tampers"]]
            assert len(set(lanes)) == len(lanes) == SMALL["tampered_lanes"]


def test_kinds_follow_the_geometry():
    gl32, _ = _load("starky_fib_gl", 32)
    gl2k, _ = _load("starky_fib_gl", 2048)
    bn2k, _ = _load("starky_fib_bn254caps", 2048)
    assert "step" not in traffic.kinds_for(gl32)
    assert "cap_raised" not in traffic.kinds_for(gl2k)
    assert set(traffic.kinds_for(bn2k)) == set(traffic.KINDS)


def test_reference_lanes_carry_the_writes():
    geom, fields = _load("starky_fib_gl", 32)
    plan = traffic.make_plan(7, SMALL, geom, fields)
    lanes = traffic.reference_lanes(plan, fields)
    n = len(fields["pow_witness"])
    j = n
    for b in plan:
        for lane, _, writes in b["tampers"]:
            src = int(b["sources"][lane])
            for field, li, index, value in writes:
                got = lanes[field] if li is None else lanes[field][li]
                old = fields[field] if li is None else fields[field][li]
                assert int(got[(j,) + index]) == value
                assert int(old[(src,) + index]) != value
            j += 1
    verdicts = np.arange(j) % 2 == 0
    exp = traffic.expected(plan, verdicts, n)
    for b, e in zip(plan, exp):
        assert e.shape == (SMALL["batch"],)
        untampered = np.ones(SMALL["batch"], dtype=bool)
        untampered[[lane for lane, _, _ in b["tampers"]]] = False
        assert (e[untampered] == verdicts[b["sources"][untampered]]).all()

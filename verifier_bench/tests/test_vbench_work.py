"""The work counts of `merkle_roofline` and the frozen roofline
arithmetic."""

import pytest

from verifier_bench import harness, work
from verifier_bench.reference import geometry


def _geom(config, rows):
    return geometry.geometry(harness.read_json(harness.part("configs", config)),
                             rows)


def test_permutation_costs():
    assert work.GL_PERM_MULS == 6436
    assert work.BN_PERM_MULS == 82688


def test_n32_flagship_504_compressions():
    w = work.merkle_work(_geom("starky_fib_gl", 32))
    assert w["compressions"] == 84 * 3 * 2 == 504
    assert w["sponge_perms"] == 0           # oracles 4, 2, 2 wide: no sponge


@pytest.mark.parametrize("config,sponge", [("starky_fib_gl", 84 * 2 * 4),
                                           ("starky_fib_bn254caps",
                                            84 * (1 + 2 * 4))])
def test_n2048_counts_from_the_shape(config, sponge):
    g = _geom(config, 2048)
    assert g.initial_depth == 8 and g.step_depths == (4, 0)
    w = work.merkle_work(g)
    # three oracles at depth 8, steps at depth 4 and 0; 32-wide step leaves
    assert w["compressions"] == 84 * (3 * 8 + 4 + 0) == 2352
    assert w["sponge_perms"] == sponge
    per = work.GL_PERM_MULS if g.hasher == "poseidon_goldilocks" \
        else work.BN_PERM_MULS
    assert w["ops"] == (2352 + sponge) * per
    leaves = 84 * (4 + 2 + 2 + 32 + 32) * 8
    assert w["bytes"] == leaves + 84 * 28 * 32 + 5 * 16 * 32


def test_least_seconds_takes_the_larger_bound():
    assert work.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, work.IMAD_PER_S) == pytest.approx(1.0)
    assert work.least_seconds(3.35e12, 2 * work.IMAD_PER_S) == \
        pytest.approx(2.0)

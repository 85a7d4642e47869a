"""Kernel K10's plain version and wrapper (`ops/goldilocks_kernels.py`) and
`tools/torch_sol_bench.py:measure_gl_mul_sol`, on the CPU.  The kernel
itself runs only on a CUDA card (`chip_smoke.py` holds it against the
plain version there)."""

import inspect
import os
import sys

import numpy as np
import pytest
import torch

from halo2_plonky2_verifier_tpu_torch.ops import _build
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks as tgl
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks_kernels as glk
from halo2_plonky2_verifier_tpu_torch.utils import profiling, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import sol_bench  # noqa: E402
import torch_sol_bench  # noqa: E402

P = tgl.P
EDGES = (0, 1, P - 1, P - 2)


def _planes(rng, lo, shift):
    x = rng.integers(lo, P, size=(8, 64), dtype=np.uint64)
    for r in range(8):                  # the edge values in the first lanes
        x[r, :len(EDGES)] = [EDGES[(r + j + shift) % len(EDGES)]
                             for j in range(len(EDGES))]
    return x


def test_plain_equals_the_jax_gl_mul_chain():
    """8 x 64 lanes, chain 8, the edge values in the first lanes of both
    factors: the plain K10 equals 8 products of the JAX `gl.mul`."""

    from halo2_plonky2_verifier_tpu.ops import goldilocks as jgl

    rng = np.random.default_rng(0)
    x, y = _planes(rng, 0, 0), _planes(rng, 1, 1)
    jx, jy = jgl.from_u64(x), jgl.from_u64(y)
    for _ in range(8):
        jx = jgl.mul(jx, jy)
    want = np.asarray(jgl.to_u64(jx))
    got = glk.mul_chain_plain(tgl.from_u64(x), tgl.from_u64(y), 8)
    assert np.array_equal(tgl.to_u64(got), want)
    ints = [[a * pow(b, 8, P) % P for a, b in zip(xr, yr)]
            for xr, yr in zip(x.tolist(), y.tolist())]
    assert tgl.to_u64(got).tolist() == ints


def test_wrapper_on_the_cpu_and_its_guards():
    rng = np.random.default_rng(1)
    x = tgl.from_u64(_planes(rng, 0, 2))
    y = tgl.from_u64(_planes(rng, 1, 3))
    assert torch.equal(glk.mul_chain(x, y, 3), glk.mul_chain_plain(x, y, 3))
    copy = glk.mul_chain(x, y, 0)           # chain 0: a copy of x
    assert torch.equal(copy, x) and copy.data_ptr() != x.data_ptr()
    assert glk.mul_chain.launches == 0      # the CPU runs no kernel
    with pytest.raises(ValueError, match="chain"):
        glk.mul_chain(x, y, -1)
    with pytest.raises(ValueError, match="shape"):
        glk.mul_chain(x, y[:, :32].contiguous(), 1)
    with pytest.raises(TypeError):
        glk.mul_chain(x, y.to(torch.int32), 1)
    with pytest.raises(ValueError, match="contiguous"):
        glk.mul_chain(x.T, y.T, 1)
    assert _build.KERNELS["gl_mul_chain"][:2] == ("gl_mul_chain.cu",
                                                  "launch_gl_mul_chain")
    assert (_build.CSRC / "gl_mul_chain.cu").exists()


def test_census_counts_chain_products_a_lane():
    x = torch.ones((8, 5), dtype=torch.int64)
    for fn in (glk.mul_chain, glk.mul_chain_plain):
        with profiling.profile() as t:
            fn(x, x, 6)
        assert t.root.counts == {"gl_mul": 6 * 40}


def test_bound_and_the_jax_probe_signature():
    """K10's bound at the probe's size: 1.72e10 IMAD in 1.03 ms, its 403 MB
    in 0.12 ms; the probe takes the JAX probe's arguments and defaults."""
    nbytes, ops = roofline.gl_mul_chain(8 << 21, 256)
    assert (nbytes, ops) == (402_653_184, 17_179_869_184)
    ms, by = roofline.bound(nbytes, ops)
    assert by == "operations" and 1.02 < ms < 1.04
    assert 0.11 < nbytes / roofline.HBM_BYTES_PER_S * 1e3 < 0.13
    jax_params = inspect.signature(sol_bench.measure_gl_mul_sol).parameters
    params = inspect.signature(torch_sol_bench.measure_gl_mul_sol).parameters
    for name, p in jax_params.items():
        assert params[name].default == p.default
    assert params["device"].default == "cuda"


def test_measure_gl_mul_sol_on_the_cpu():
    rate, sec = torch_sol_bench.measure_gl_mul_sol(n_lanes=16, chain=4,
                                                   reps=2, device="cpu")
    assert rate > 0 and sec > 0
    assert np.isclose(rate * sec, 8 * 16 * 4)

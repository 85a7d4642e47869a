"""The PyTorch port's bulk Goldilocks hashing API (`ops/poseidon.py`, kernel
K7), the chained permutation (K8), the BN254 component probes (K9) and the
speed-of-light tools, on the CPU at small sizes.

The batch-last functions are held against the JAX package's jnp path
(`ops/poseidon.py`, never a Pallas kernel in interpret mode) and the
pure-int reference `refimpl/poseidon.py`; the plain K8 against the jnp
`permute_planes` applied `chain` times; each plain K9 probe against
Python-int Montgomery arithmetic (BN254) or numpy (the u32 and f32
multipliers).  Inputs are made from a seed with numpy; every result is an
integer (the f32 probe's values are integers below 2^17), so the tolerance is
exact equality.
"""

import inspect
import math
import os
import sys

import numpy as np
import pytest
import torch

from halo2_plonky2_verifier_tpu.constants import poseidon_bn254 as jbn
from halo2_plonky2_verifier_tpu.ops import goldilocks as jgl
from halo2_plonky2_verifier_tpu.ops import poseidon as jpos
from halo2_plonky2_verifier_tpu.refimpl import poseidon as ref
from halo2_plonky2_verifier_tpu.refimpl import poseidon_bn254 as bn_ref
from halo2_plonky2_verifier_tpu.utils.compile import smart_jit
from halo2_plonky2_verifier_tpu_torch.ops import bn254_micro_kernels as mk9
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks as tgl
from halo2_plonky2_verifier_tpu_torch.ops import merkle_kernels as mk
from halo2_plonky2_verifier_tpu_torch.ops import poseidon as tpos
from halo2_plonky2_verifier_tpu_torch.ops import poseidon_kernels as pk
from halo2_plonky2_verifier_tpu_torch.ops import transcript_kernels as tk
from halo2_plonky2_verifier_tpu_torch.utils import roofline

sys.path.append(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import torch_bn254_micro  # noqa: E402
import torch_sol_bench  # noqa: E402

P = tgl.P
FR_P = jbn.P_BN254
R = 1 << 256
R_INV = pow(R, -1, FR_P)


def _rand(seed, shape):
    x = np.random.default_rng(seed).integers(0, P, size=shape,
                                             dtype=np.uint64)
    if x.size >= 2:
        x.reshape(-1)[:2] = [0, P - 1]
    return x


def _rows(t):
    """int64 tensor (..., k) -> nested lists of host ints per last axis."""
    u = tgl.to_u64(t)
    return [[int(v) for v in row] for row in u.reshape(-1, u.shape[-1])]


def _same(torch_out, jax_out):
    np.testing.assert_array_equal(tgl.to_u64(torch_out), jgl.to_u64(jax_out))


# ----------------------------------------------------------------------------
# the batch-last API
# ----------------------------------------------------------------------------

def test_permute_batch_last_vs_jax():
    x = _rand(1, (3, 5, 12))
    got = tpos.permute(tgl.from_u64(x))
    assert got.shape == (3, 5, 12)
    _same(got, smart_jit(jpos.permute)(jgl.from_u64(x)))


def test_two_to_one_vs_jax():
    left, right = _rand(2, (7, 4)), _rand(3, (7, 4))
    _same(tpos.two_to_one(tgl.from_u64(left), tgl.from_u64(right)),
          smart_jit(jpos.two_to_one)(jgl.from_u64(left),
                                     jgl.from_u64(right)))


def test_hash_no_pad_vs_jax():
    x = _rand(4, (2, 3, 13))       # one full chunk and a remainder of 5
    _same(tpos.hash_no_pad(tgl.from_u64(x)),
          smart_jit(jpos.hash_no_pad)(jgl.from_u64(x)))


@pytest.mark.parametrize("k", [0, 3, 8, 13, 24])
def test_absorb_vs_refimpl(k):
    state, inputs = _rand(10 + k, (4, 12)), _rand(40 + k, (4, k))
    got = tpos.absorb(tgl.from_u64(state), tgl.from_u64(inputs))
    assert got.shape == (4, 12)
    want = [ref.absorb([int(v) for v in s], [int(v) for v in i])
            for s, i in zip(state, inputs)]
    assert _rows(got) == want
    if k == 0:
        assert _rows(got) == _rows(tgl.from_u64(state))


@pytest.mark.parametrize("k", [2, 4, 5, 60])
def test_hash_or_noop_vs_refimpl(k):
    x = _rand(70 + k, (3, k))
    got = tpos.hash_or_noop(tgl.from_u64(x))
    assert got.shape == (3, 4)
    assert _rows(got) == [ref.hash_or_noop([int(v) for v in r]) for r in x]


def test_zero_state():
    z = tpos.zero_state((2, 3), device="cpu")
    assert z.shape == (2, 3, 12) and z.dtype == torch.int64
    assert not z.any()


def test_zero_state_defaults_to_the_card():
    """The bulk API's constructor puts the state on the card unless the
    caller asks for the CPU, so absorb(zero_state(shape), x) reaches K7."""
    default = inspect.signature(tpos.zero_state).parameters["device"].default
    assert torch.device(default).type == "cuda"


# ----------------------------------------------------------------------------
# K7 and K8
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("chain", [0, 1, 3])
def test_permute_planes_chained_plain_vs_jax(chain):
    x = _rand(90 + chain, (12, 24))
    want = jgl.from_u64(x)
    step = smart_jit(jpos.permute_planes)
    for _ in range(chain):
        want = step(want)
    got = pk.permute_planes_chained_plain(tgl.from_u64(x), chain)
    _same(got, want)
    assert torch.equal(pk.permute_planes_chained(tgl.from_u64(x), chain), got)


def test_dispatching_permute_planes_runs_plain_on_cpu():
    x = tgl.from_u64(_rand(95, (12, 16)))
    before = (pk.permute_planes.launches, pk.permute_planes_chained.launches)
    assert torch.equal(tpos.permute_planes(x), tpos.permute_planes_plain(x))
    assert torch.equal(pk.permute_planes(x), tpos.permute_planes_plain(x))
    after = (pk.permute_planes.launches, pk.permute_planes_chained.launches)
    assert after == before                    # no kernel on the CPU


def test_plain_k1_k3_call_no_dispatching_function(monkeypatch):
    """The plain versions of K1-K3 must not reach K7 (or K3's wrapper)
    through the dispatching functions: on the card they are the reference
    the kernels are held against."""
    rng = np.random.default_rng(97)
    node = tgl.from_u64(_rand(98, (4, 8)))
    sib = tgl.from_u64(_rand(99, (3, 4, 8)))
    idx = torch.from_numpy(rng.integers(0, 8, size=8))
    active = torch.ones((3, 8), dtype=torch.int32)
    chunks = tgl.from_u64(_rand(100, (2, 8, 5)))
    mask = torch.tensor([[1] * 8, [1] * 3 + [0] * 5], dtype=torch.int32)
    leaves = tgl.from_u64(_rand(101, (13, 6)))
    runs = [lambda: mk.verify_paths_planes_plain(node, sib, idx, active),
            lambda: tk.run_steps_planes_plain(chunks, mask),
            lambda: mk.hash_no_pad_planes_plain(leaves)]
    before = [run() for run in runs]

    def boom(*args, **kwargs):
        raise AssertionError("a plain version called a dispatching function")

    for mod, name in ((tpos, "permute_planes"), (tpos, "two_to_one_planes"),
                      (tpos, "hash_no_pad_planes"), (pk, "permute_planes"),
                      (pk, "permute_planes_chained"),
                      (mk, "hash_no_pad_planes"),
                      (mk, "verify_paths_planes"),
                      (tk, "run_steps_planes")):
        monkeypatch.setattr(mod, name, boom)
    for mod in (mk, tk):
        for name in ("permute_planes", "two_to_one_planes"):
            monkeypatch.setattr(mod, name, boom, raising=False)
    for run, want in zip(runs, before):
        assert torch.equal(run(), want)
    dispatching = {"permute_planes", "two_to_one_planes", "hash_no_pad_planes",
                   "verify_paths_planes", "run_steps_planes",
                   "permute_planes_chained"}
    for fn in (mk.verify_paths_planes_plain, tk.run_steps_planes_plain,
               mk.hash_no_pad_planes_plain, tpos.permute_planes_plain,
               tpos.two_to_one_planes_plain):
        assert not dispatching & set(fn.__code__.co_names), fn.__name__


# ----------------------------------------------------------------------------
# K9: the BN254 component probes
# ----------------------------------------------------------------------------

def _mont(v):
    return v * R % FR_P


def _std(v):
    return v * R_INV % FR_P


def _fr_words(vals):
    """(N, E) host ints -> (4 E, N) int64 planes."""
    u = np.array([[(v >> (64 * k)) & ((1 << 64) - 1) for v in row
                   for k in range(4)] for row in vals], dtype=np.uint64)
    return tgl.from_u64(u.T.copy())


def _fr_vals(planes):
    u = tgl.to_u64(planes).T
    return [[sum(int(row[4 * e + k]) << (64 * k) for k in range(4))
             for e in range(u.shape[1] // 4)] for row in u]


def _std_round(state, r):
    c, m = jbn.generate()
    state = [(s + c[r * 4 + i]) % FR_P for i, s in enumerate(state)]
    state[0] = pow(state[0], 5, FR_P)
    return [sum(m[i][j] * state[j] for j in range(4)) % FR_P
            for i in range(4)]


def _mix(state):
    _, m = jbn.generate()
    return [sum(_mont(m[i][j]) * state[j] for j in range(4)) * R_INV % FR_P
            for i in range(4)]


def _fr_step(name, s, i):
    """One iteration of probe `name` on one lane's Montgomery values."""
    r = jbn.FULL_ROUNDS // 2 + i % jbn.PARTIAL_ROUNDS
    if name == "sqr_redc":
        return [s[0] * s[0] * R_INV % FR_P]
    if name == "mont_mul":
        return [s[0] * s[1] * R_INV % FR_P, s[1]]
    if name == "redc":
        return [s[0] * R_INV % FR_P]
    if name == "mix":
        return _mix(s)
    if name == "permute":
        return [_mont(v) for v in bn_ref.permute([_std(v) for v in s])]
    states = [s[k:k + 4] for k in range(0, len(s), 4)]   # partial rounds
    return [_mont(v) for st in states
            for v in _std_round([_std(v) for v in st], r)]


FR_CHAINS = {"sqr_redc": 5, "mont_mul": 5, "redc": 5, "mix": 3,
             "partial_round": 3, "partial_round_x2": 2, "permute": 1}


@pytest.mark.parametrize("name", sorted(FR_CHAINS))
def test_k9_fr_probe_plain_vs_python_ints(name):
    rng = np.random.default_rng(200 + sorted(FR_CHAINS).index(name))
    lanes = 2 if name == "permute" else 3
    elems = mk9.PROBES[name][1] // 4
    vals = [[int.from_bytes(rng.bytes(32), "little") % FR_P
             for _ in range(elems)] for _ in range(lanes)]
    vals[0][0] = FR_P - 1
    chain = FR_CHAINS[name]
    got = mk9.run_probe_plain(name, _fr_words(vals), chain)
    assert got.shape == (4 * elems, lanes)
    want = []
    for row in vals:
        for i in range(chain):
            row = _fr_step(name, row, i)
        want.append(row)
    assert _fr_vals(got) == want


def test_k9_multiplier_probes_plain_vs_numpy():
    words = np.random.default_rng(7).integers(0, np.iinfo(np.uint64).max,
                                              size=(1, 64), dtype=np.uint64,
                                              endpoint=True)
    words[0, :3] = [0, 0xFFFF, np.iinfo(np.uint64).max]
    chain = 4
    x = (words & np.uint64(0xFFFF)).astype(np.uint32)
    f = x.astype(np.float32)
    for _ in range(chain):
        for j in range(16):
            x = (x * (x ^ np.uint32(j))) & np.uint32(0xFFFF) | np.uint32(1)
            f = np.fmod(f * (f + np.float32(j + 1)),
                        np.float32(65536)) + np.float32(1)
    state = tgl.from_u64(words)
    u32 = mk9.run_probe_plain("u32_mul16", state, chain)
    f32 = mk9.run_probe_plain("f32_mul16", state, chain)
    np.testing.assert_array_equal(u32.numpy(), x.astype(np.int64))
    np.testing.assert_array_equal(f32.numpy(), f.astype(np.int64))
    assert f32.max() <= 65536 and f32.min() >= 1
    # products above 2^24 were rounded: the f32 chain is not the exact one
    assert (f * (f + 16) >= 1 << 24).any()
    # chain 0 returns the low 16 bits of each word
    np.testing.assert_array_equal(
        mk9.run_probe_plain("u32_mul16", state, 0).numpy(),
        (words & np.uint64(0xFFFF)).astype(np.int64))


def test_k9_wrapper_runs_plain_on_cpu():
    x = torch_bn254_micro.probe_input("mix", 4, np.random.default_rng(3),
                                      "cpu")
    before = mk9.run_probe.launches
    assert torch.equal(mk9.run_probe("mix", x, 2),
                       mk9.run_probe_plain("mix", x, 2))
    assert mk9.run_probe.launches == before


# ----------------------------------------------------------------------------
# wrapper guards
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    "k7_dtype", "k7_shape", "k7_contiguous", "k7_device", "k8_chain",
    "k8_chain_type", "k9_probe", "k9_threads", "k9_rows", "k9_chain"])
def test_wrappers_reject_bad_inputs(bad):
    st = tgl.from_u64(_rand(120, (12, 8)))
    fr_state = torch_bn254_micro.probe_input("permute", 8,
                                             np.random.default_rng(4), "cpu")
    calls = {
        "k7_dtype": lambda: pk.permute_planes(st.to(torch.int32)),
        "k7_shape": lambda: pk.permute_planes(st[:11].contiguous()),
        "k7_contiguous": lambda: pk.permute_planes(st.T.contiguous().T),
        "k7_device": lambda: pk.permute_planes(st.to("meta")),
        "k8_chain": lambda: pk.permute_planes_chained(st, -1),
        "k8_chain_type": lambda: pk.permute_planes_chained(st, 2.0),
        "k9_probe": lambda: mk9.run_probe("cube", fr_state, 1),
        "k9_threads": lambda: mk9.run_probe("mix", fr_state, 1, threads=256),
        "k9_rows": lambda: mk9.run_probe("redc", fr_state, 1),
        "k9_chain": lambda: mk9.run_probe("permute", fr_state, -2),
    }
    with pytest.raises((TypeError, ValueError)):
        calls[bad]()


# ----------------------------------------------------------------------------
# the bound and the tools, at tiny sizes on the CPU
# ----------------------------------------------------------------------------

def test_roofline_counts_and_k7_bound():
    assert roofline.GL_PERM_MULS == 6436
    assert roofline.BN_PERM_MULS == 82688
    ms, by = roofline.bound(2 * 12 * (1 << 21) * 8,
                            (1 << 21) * roofline.GL_PERM_MULS)
    assert by == "operations" and abs(ms - 0.8069) < 1e-3
    ms, by = roofline.bound(2 * 12 * (1 << 21) * 8, 0)
    assert by == "bytes" and abs(ms - 0.1202) < 1e-3


def test_measure_poseidon_sol_cpu_tiny():
    probes = (("chained", "K8", 8, 2), ("streamed", "K7", 16, 1),
              ("mid", "K8", 16, 2), ("merkle-path", "K1", 8, 2))
    lines = []
    pps, sec, rows = torch_sol_bench.measure_poseidon_sol(
        device="cpu", reps=1, probes=probes, log=lines.append)
    assert [r["name"] for r in rows] == [p[0] for p in probes]
    assert len(lines) == 4
    for r in rows:
        assert math.isfinite(r["perm_per_sec"]) and r["perm_per_sec"] > 0
        assert 0 < r["share"] and r["bound_by"] == "operations"
    assert pps == max(r["perm_per_sec"] for r in rows)
    assert sec > 0


def test_bn254_micro_measure_cpu_tiny(monkeypatch):
    monkeypatch.setattr(torch_bn254_micro, "RUNS", (
        ("sqr_redc", 128), ("mont_mul", 128), ("u32_mul16", 128),
        ("f32_mul16", 128)))
    rows = torch_bn254_micro.measure(device="cpu", lanes=4, chain=2, reps=1)
    assert [r["probe"] for r in rows] == ["sqr_redc", "mont_mul",
                                          "u32_mul16", "f32_mul16"]
    for r in rows:
        assert math.isfinite(r["ns_per_iter_lane"]) and r["ms"] > 0
        assert r["bound_ms"] > 0

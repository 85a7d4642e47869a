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
from halo2_plonky2_verifier_tpu_torch.constants import poseidon_bn254_opt as tpo
from halo2_plonky2_verifier_tpu_torch.ops import _build
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


def _opt_tables():
    """The optimized schedule's tables by round, plain field values: the
    port's layout (`constants/poseidon_bn254_opt.py:round_tables`) of the
    JAX package's `refimpl/poseidon_bn254_opt.py:opt_tables()`
    (`tests/test_torch_bn254_opt.py` holds the two equal)."""
    return tpo.round_tables()


def _full_round(v, r):
    """Full round r of the optimized schedule on standard-form ints."""
    t = _opt_tables()
    v = [(pow((x + t["pre"][r][e]) % FR_P, 5, FR_P) + t["post"][r][e])
         % FR_P for e, x in enumerate(v)]
    return [sum(t["mix"][r][f][e] * v[e] for e in range(4)) % FR_P
            for f in range(4)]


def _partial_round(v, i):
    """Partial round i of the optimized schedule on standard-form ints."""
    t = _opt_tables()
    s0 = (pow(v[0], 5, FR_P) + t["gamma"][i]) % FR_P
    v = [s0] + v[1:]
    return ([sum(t["row0"][i][e] * v[e] for e in range(4)) % FR_P]
            + [(v[k] + t["col0"][i][k - 1] * s0) % FR_P for k in range(1, 4)])


def _in_std(fn):
    """A step on Montgomery values from one on standard-form values."""
    return lambda s, *a: [_mont(v) for v in fn([_std(v) for v in s], *a)]


def _fr_step(name, s, i):
    """One iteration of probe `name` on one lane's Montgomery values."""
    if name == "sqr_redc":
        return [s[0] * s[0] * R_INV % FR_P]
    if name == "mont_mul":
        return [s[0] * s[1] * R_INV % FR_P, s[1]]
    if name == "redc":
        return [s[0] * R_INV % FR_P]
    if name == "sbox":
        return _in_std(lambda v: [pow(v[0], 5, FR_P)])(s)
    if name in ("permute", "permute_group4"):
        return _in_std(bn_ref.permute)(s)
    if name == "full_round":
        return _in_std(_full_round)(s, i % jbn.FULL_ROUNDS)
    states = [s[k:k + 4] for k in range(0, len(s), 4)]   # partial rounds
    return [v for st in states for v in _in_std(_partial_round)(
        st, i % jbn.PARTIAL_ROUNDS)]


# full_round and partial_round_sparse run past their last round, so the
# chain's wrap to round 0 is covered
FR_CHAINS = {"sqr_redc": 5, "mont_mul": 5, "redc": 5, "sbox": 3,
             "full_round": 9, "partial_round_sparse": 57,
             "partial_round_sparse_x2": 3, "permute": 1, "permute_group4": 1}


@pytest.mark.parametrize("name", sorted(FR_CHAINS))
def test_k9_fr_probe_plain_vs_python_ints(name):
    rng = np.random.default_rng(200 + sorted(FR_CHAINS).index(name))
    lanes = 2 if name.startswith("permute") else 3
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


def test_k9_round_probes_compose_to_the_permutation():
    """The plain round probes' steps in the schedule's order (full rounds
    0..3, partial rounds 0..55, full rounds 4..7) are the permutation of
    `refimpl/poseidon_bn254.py` on Python ints: the parts that
    `tools/torch_bn254_micro.py` adds up are the permutation's."""
    rng = np.random.default_rng(210)
    vals = [[int.from_bytes(rng.bytes(32), "little") % FR_P
             for _ in range(4)] for _ in range(2)]
    vals[0] = [0, 1, FR_P - 1, FR_P - 2]
    s = _fr_words([[_mont(v) for v in row] for row in vals])
    half = jbn.FULL_ROUNDS // 2
    schedule = ([("full_round", r) for r in range(half)]
                + [("partial_round_sparse", i)
                   for i in range(jbn.PARTIAL_ROUNDS)]
                + [("full_round", r) for r in range(half, jbn.FULL_ROUNDS)])
    words = s.T.reshape(-1, 4, 4)
    for name, i in schedule:
        words = mk9.FR_STEPS[name](words, i)
    got = _fr_vals(words.reshape(words.shape[0], -1).T.contiguous())
    assert [[_std(v) for v in row] for row in got] == [
        bn_ref.permute(row) for row in vals]


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


def test_k9_f32_floor_form_equals_fmod():
    """The kernel's f32 reduction v - floor(v 2^-16) 65536 (csrc/
    bn254_micro.cu) equals fmod(v, 65536) bit for bit on every product the
    f32 probe can form: v = x (x + j + 1) rounded to f32, x in [0, 65536],
    j in 0..15."""
    x = np.arange(65537, dtype=np.float32)
    for j in range(16):
        v = x * (x + np.float32(j + 1))
        assert v.dtype == np.float32
        floor = v - np.floor(v * np.float32(2.0 ** -16)) * np.float32(65536)
        want = np.fmod(v, np.float32(65536))
        np.testing.assert_array_equal(floor.view(np.uint32),
                                      want.view(np.uint32))


def test_k9_wide_probe_plain_vs_python_ints():
    """The wide probe: 16 times x = hi32(x) c_j + x mod 2^64 a chain step,
    c_j = 0x1E3779B9 + 2j, the constants the kernel's source states."""
    assert mk9.WIDE_C == tuple(0x1E3779B9 + 2 * j for j in range(16))
    source = (_build.CSRC / "bn254_micro.cu").read_text()
    assert "0x1E3779B9u + 2u * (uint32_t)j" in source
    words = np.random.default_rng(8).integers(
        0, np.iinfo(np.uint64).max, size=(1, 32), dtype=np.uint64,
        endpoint=True)
    words[0, :3] = [0, 1 << 32, np.iinfo(np.uint64).max]
    chain = 5
    got = tgl.to_u64(mk9.run_probe_plain("wide_mul16", tgl.from_u64(words),
                                         chain))
    for lane in range(words.shape[1]):
        x = int(words[0, lane])
        for _ in range(chain):
            for c in mk9.WIDE_C:
                x = ((x >> 32) * c + x) % (1 << 64)
        assert int(got[0, lane]) == x
    assert len(set(got[0].tolist())) == words.shape[1]


def test_k9_wrapper_runs_plain_on_cpu():
    x = torch_bn254_micro.probe_input("full_round", 4,
                                      np.random.default_rng(3), "cpu")
    before = mk9.run_probe.launches
    assert torch.equal(mk9.run_probe("full_round", x, 2),
                       mk9.run_probe_plain("full_round", x, 2))
    assert mk9.run_probe.launches == before


def test_k9_ptxas_usage_by_kernel_instance():
    """The registers and spill of each K9 template instance, read from
    nvcc's -Xptxas -v lines, under the name `kernel_instance` gives a
    run."""
    text = """ptxas info    : Compiling entry function '_Z18bn254_micro_kernelILi7ELi512EEvPKmPmli' for 'sm_90a'
ptxas info    : Function properties for _Z18bn254_micro_kernelILi7ELi512EEvPKmPmli
    8 bytes stack frame, 28 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z22bn254_micro_mul_kernelILi11ELi8EEvPKmPmlli' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 0 barriers
ptxas info    : Compiling entry function '_Z25bn254_micro_group4_kernelPKmPmli' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 20480 bytes smem
"""
    usage = torch_bn254_micro.ptxas_usage(text)
    ki = torch_bn254_micro.kernel_instance
    assert usage[ki("permute", 0, 1)] == {"registers": 128,
                                          "spill_bytes": 28}
    assert usage[ki("permute", 512, 1)] == usage[ki("permute", 0, 1)]
    assert usage[ki("wide_mul16", 0, 8)] == {"registers": 24,
                                             "spill_bytes": 0}
    assert usage[ki("permute_group4", 0, 1)]["registers"] == 80
    assert ki("permute", 128, 1) == "bn254_micro_kernel<7,128>"
    assert torch_bn254_micro.instance("main") is None


# ----------------------------------------------------------------------------
# wrapper guards
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    "k7_dtype", "k7_shape", "k7_contiguous", "k7_device", "k8_chain",
    "k8_chain_type", "k9_probe", "k9_threads", "k9_rows", "k9_chain",
    "k9_group4_threads", "k9_fr_k", "k9_mul_k", "k9_mul_threads",
    "k9_wide_rows"])
def test_wrappers_reject_bad_inputs(bad):
    st = tgl.from_u64(_rand(120, (12, 8)))
    fr_state = torch_bn254_micro.probe_input("permute", 8,
                                             np.random.default_rng(4), "cpu")
    word = torch_bn254_micro.probe_input("wide_mul16", 8,
                                         np.random.default_rng(5), "cpu")
    calls = {
        "k7_dtype": lambda: pk.permute_planes(st.to(torch.int32)),
        "k7_shape": lambda: pk.permute_planes(st[:11].contiguous()),
        "k7_contiguous": lambda: pk.permute_planes(st.T.contiguous().T),
        "k7_device": lambda: pk.permute_planes(st.to("meta")),
        "k8_chain": lambda: pk.permute_planes_chained(st, -1),
        "k8_chain_type": lambda: pk.permute_planes_chained(st, 2.0),
        "k9_probe": lambda: mk9.run_probe("cube", fr_state, 1),
        "k9_threads": lambda: mk9.run_probe("full_round", fr_state, 1,
                                            threads=256),
        "k9_rows": lambda: mk9.run_probe("redc", fr_state, 1),
        "k9_chain": lambda: mk9.run_probe("permute", fr_state, -2),
        "k9_group4_threads": lambda: mk9.run_probe(
            "permute_group4", fr_state, 1, threads=128),
        "k9_fr_k": lambda: mk9.run_probe("permute", fr_state, 1, k=4),
        "k9_mul_k": lambda: mk9.run_probe("u32_mul16", word, 1, k=2),
        "k9_mul_threads": lambda: mk9.run_probe("wide_mul16", word, 1,
                                                threads=128),
        "k9_wide_rows": lambda: mk9.run_probe("wide_mul16", fr_state, 1),
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
    runs = (("sqr_redc", 0, 1), ("full_round", 0, 1),
            ("partial_round_sparse", 0, 1),
            ("partial_round_sparse_x2", 0, 1), ("permute", 0, 1),
            ("u32_mul16", 0, 4), ("f32_mul16", 0, 1), ("wide_mul16", 0, 8))
    assert set(runs) <= set(torch_bn254_micro.RUNS)
    monkeypatch.setattr(torch_bn254_micro, "RUNS", runs)
    lines = []
    rows, summary = torch_bn254_micro.measure(
        device="cpu", lanes=2, mul_lanes=9, chain=1, reps=1,
        log=lines.append)
    assert [(r["probe"], r["k"]) for r in rows] == [
        (name, k) for name, _, k in runs]
    assert [r["lanes"] for r in rows] == [2] * 5 + [9] * 3
    for r in rows:
        assert math.isfinite(r["ns_per_iter_lane"]) and r["ms"] > 0
        assert r["bound_ms"] > 0
        assert r["launch_threads"] is None        # no launch on the CPU
    parts = summary["parts"]
    assert parts["sum_ms"] == pytest.approx(8 * parts["full_ms"]
                                            + 56 * parts["partial_ms"])
    assert summary["x2_over_x1"] > 0
    assert [(r["probe"], r["peak_per_clock_sm"], r["per_clock_sm"])
            for r in summary["rates"]] == [("u32_mul16", 64, None),
                                           ("f32_mul16", 128, None),
                                           ("wide_mul16", 64, None)]
    assert len(lines) == 8 + 2

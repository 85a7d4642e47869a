"""The PyTorch port's verification service (`serve.py`, `tools/torch_serve.py`)
and its logger, on the CPU.

The protocol loop runs on a StringIO: both families, both hashers, both
proof formats, the power-of-two bucket padding, the verifier cache
(`compile_s` null on a repeat), a malformed line, an unknown family and an
empty `proofs`; every verdict is held against refimpl's (computed here, or
for the plonkish proofs read from `tests/fixtures/plonkish_verdicts.json`,
which `tools/gen_torch_plonkish_fixtures.py` wrote with refimpl).  The JAX
`tools/serve.py` is not run: it would compile the JAX verifier.
`tools/torch_serve.py --self-test --device cpu` runs in a process in which
every import of jax is refused; it starts with the first test of this file
and runs beside the others.  Booleans: the tolerance is 0.
"""

import io
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from halo2_plonky2_verifier_tpu.models.fibonacci import \
    FibonacciStark as JaxFibonacciStark
from halo2_plonky2_verifier_tpu.refimpl import hashers
from halo2_plonky2_verifier_tpu.refimpl import verifier as ref_verifier
from halo2_plonky2_verifier_tpu.refimpl.proof import \
    proof_from_json as jax_proof_from_json
from halo2_plonky2_verifier_tpu.utils import logging as jax_logging
from halo2_plonky2_verifier_tpu.utils.config import \
    StarkConfig as JaxStarkConfig
from halo2_plonky2_verifier_tpu_torch.fixtures import read_docs, tampered
from halo2_plonky2_verifier_tpu_torch.serve import VerifierService
from halo2_plonky2_verifier_tpu_torch.utils import logging as tlogging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
SERVE = os.path.join(REPO, "tools", "torch_serve.py")

_NO_JAX = textwrap.dedent("""
    import runpy
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
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")
    loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not loaded, loaded
""")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain path's ops are small, so more threads only contend for
    the cores with the other test processes: one thread for this file,
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def self_test_proc():
    """`tools/torch_serve.py --self-test --device cpu` without jax, started
    before the first test of this file so that it runs beside them, on one
    thread (its ops are small: more threads only contend for the cores)."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _NO_JAX, SERVE, "--self-test", "--device",
         "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"})
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _request(rid, family, name, picks, hasher="poseidon_goldilocks",
             fmt="native"):
    """A request of the proofs `picks` ([(index, tamper or None)]) of a
    fixture file, as strings, the first as a parsed object."""
    docs = read_docs(name)
    proofs = [docs[i] if t is None else tampered(docs[i], t, fmt)
              for i, t in picks]
    return {"id": rid, "stark": {"family": family, "num_rows": 32},
            "hasher": hasher, "format": fmt,
            "proofs": [proofs[0]] + [json.dumps(p) for p in proofs[1:]]}


def _refimpl_fib(name, picks, hasher=None):
    docs = read_docs(name)
    out = []
    for i, t in picks:
        doc = docs[i] if t is None else tampered(docs[i], t)
        try:
            ref_verifier.verify(JaxFibonacciStark(32),
                                jax_proof_from_json(json.dumps(doc)),
                                JaxStarkConfig.standard_fast_config(),
                                hasher=hasher)
            out.append(True)
        except ref_verifier.VerificationError:
            out.append(False)
    return out


def _refimpl_plonkish(name, picks):
    with open(os.path.join(FIXTURES, "plonkish_verdicts.json")) as f:
        entries = json.load(f)["files"][name]["verdicts"]
    table = {(e["index"], e["tamper"]): e["accepted"] for e in entries}
    return [table[p] for p in picks]


FIB_GL = ("fib_stark_n32_x8.jsonl", [(0, None), (1, "public_input"),
                                     (2, None)])
PLONKISH = ("plonkish_n32_x8.jsonl", [(0, None), (3, "late_sibling"),
                                      (2, None), (2, "quotient_opening"),
                                      (4, None)])
PLONKY2 = ("plonkish_n32_x4_plonky2.jsonl", [(1, None), (0, "public_input"),
                                             (1, "pow_witness"), (3, None),
                                             (2, None)])
FIB_BN254 = ("fib_stark_n32_poseidon_bn254_x8.jsonl", [(3, None),
                                                       (1, "public_input")])


def test_protocol_loop_on_cpu():
    reqs = [
        _request("fib-gl", "fibonacci", *FIB_GL),
        _request("plonkish", "plonkish", *PLONKISH),
        _request("plonkish-plonky2", "plonkish", *PLONKY2, fmt="plonky2"),
        _request("fib-bn254", "fibonacci", *FIB_BN254,
                 hasher="poseidon_bn254"),
        _request("fib-gl", "fibonacci", *FIB_GL),
    ]
    lines = [json.dumps(r) for r in reqs]
    lines.insert(1, '{"bad json')
    lines.insert(3, json.dumps({"id": "x", "stark": {"family": "sha256",
                                                     "num_rows": 32},
                                "proofs": reqs[0]["proofs"]}))
    lines.append(json.dumps({"id": "empty", "stark": {
        "family": "plonkish", "num_rows": 32}, "proofs": []}))
    out = io.StringIO()
    VerifierService("cpu").run(io.StringIO("\n".join(lines) + "\n\n"), out)
    resp = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(resp) == 8
    assert resp[1] == {"error": resp[1]["error"]}
    assert resp[1]["error"].startswith("JSONDecodeError")
    assert resp[3] == {"error": "ValueError: unknown stark family: sha256"}
    assert resp[7] == {"id": "empty", "verdicts": []}
    fib, plonk_, plonky2, bn254, again = (resp[i] for i in (0, 2, 4, 5, 6))
    for r in (fib, plonk_, plonky2, bn254, again):
        assert set(r) == {"id", "verdicts", "batch", "compile_s",
                          "verify_ms"}
        assert r["verify_ms"] >= 0
    # buckets: 3 -> 4, 5 -> 8, 2 -> 2; new keys pay compile_s, the
    # plonky2-format request and the repeat reuse a built verifier
    assert [r["batch"] for r in (fib, plonk_, plonky2, bn254, again)] == \
        [4, 8, 8, 2, 4]
    assert [r["compile_s"] is None
            for r in (fib, plonk_, plonky2, bn254, again)] == \
        [False, False, True, False, True]
    assert fib["verdicts"] == again["verdicts"] == _refimpl_fib(*FIB_GL) \
        == [True, False, True]
    assert plonk_["verdicts"] == _refimpl_plonkish(*PLONKISH) == \
        [True, False, True, False, True]
    assert plonky2["verdicts"] == _refimpl_plonkish(*PLONKY2) == \
        [True, False, False, True, True]
    assert bn254["verdicts"] == _refimpl_fib(
        *FIB_BN254, hasher=hashers.BN254) == [True, False]


LOG_SPECS = ["", "info", "debug", "trace", "error", "warning", "WARN",
             "bogus", "a.b=debug,info", "x=trace, y = error ,debug",
             "m=nope,error", ",,", "halo2_plonky2_verifier_tpu=info",
             "a=b=c"]


@pytest.mark.parametrize("spec", LOG_SPECS)
def test_log_grammar_matches_jax(spec):
    """The port's HALO2_TPU_LOG grammar and levels are the JAX module's."""
    assert tlogging._parse(spec) == jax_logging._parse(spec)
    assert (tlogging.ERROR, tlogging.WARN, tlogging.INFO, tlogging.DEBUG,
            tlogging.TRACE) == (jax_logging.ERROR, jax_logging.WARN,
                                jax_logging.INFO, jax_logging.DEBUG,
                                jax_logging.TRACE)


def test_service_stdout_holds_only_json():
    """With every log on (HALO2_TPU_LOG=trace), the CLI's stdout is one
    JSON response a request line; the logs go to stderr."""
    stream = "\n".join([
        '{"bad json',
        json.dumps({"id": "x", "stark": {"family": "sha256",
                                         "num_rows": 32}, "proofs": []}),
        json.dumps({"id": "e", "stark": {"family": "fibonacci",
                                         "num_rows": 32}, "proofs": []}),
    ]) + "\n"
    out = subprocess.run(
        [sys.executable, SERVE, "--device", "cpu"], input=stream,
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "HALO2_TPU_LOG": "trace"})
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert [sorted(json.loads(line)) for line in lines] == \
        [["error"], ["error"], ["id", "verdicts"]]
    assert "WARN  serve] request failed: JSONDecodeError" in out.stderr


def test_self_test_without_jax(self_test_proc):
    """The self-test (GL fibonacci, plonkish in both formats, BN254 caps;
    each tampered, each asked twice; a malformed line) passes on the CPU
    in a process that cannot import jax."""
    stdout, stderr = self_test_proc.communicate(timeout=300)
    assert self_test_proc.returncode == 0, stderr[-4000:]
    assert "serve self-test OK on cpu" in stdout

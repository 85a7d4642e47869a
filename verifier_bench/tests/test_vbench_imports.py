"""Nothing the benchmark runs loads JAX or the JAX package, by whole
top-level name; the harness refuses to run without a card or without the
program."""

import os
import shutil
import subprocess
import sys

from verifier_bench import harness

CHECK = r"""
import sys, glob, os
sys.path.insert(0, os.getcwd())
from verifier_bench import harness, control, run  # noqa: F401
for path in glob.glob("verifier_bench/metrics/*.py"):
    harness.reader(os.path.basename(path)[:-3])
harness.run_cell("fib_gl.n32.bulk", 9, 0.01, False, device="cpu",
                 overrides={"batch": 4, "tampered_lanes": 2,
                            "batches_cycled": 1})
print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_forbidden_names_are_compared_whole():
    mods = ["halo2_plonky2_verifier_tpu_torch", "halo2_plonky2_verifier_tpu_torch.ops",
            "jaxtyping", "numpy"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["halo2_plonky2_verifier_tpu.x"]) \
        == ["halo2_plonky2_verifier_tpu"]
    assert harness.forbidden_modules(["jax.numpy", "flax"]) == ["flax", "jax"]


def test_a_run_loads_no_jax(root):
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", CHECK], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(out.stdout.strip().splitlines()[-1].split(","))
    assert "halo2_plonky2_verifier_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_no_sources_read_the_jax_benchmark_files(root):
    banned = ("bench.py", "__graft_entry__", "BENCH_", "BASELINE.json",
              "import jax", "halo2_plonky2_verifier_tpu.", "from jax")
    for dirpath, _, files in os.walk(root / "verifier_bench"):
        for name in files:
            if name.endswith(".py") and "tests" not in dirpath:
                text = open(os.path.join(dirpath, name)).read()
                assert not [b for b in banned if b in text], name


def test_exits_without_a_card_and_without_the_program(root, tmp_path):
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "verifier_bench", tmp_path / "verifier_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    args = [sys.executable, "verifier_bench/run.py", "--workload",
            "fib_gl.n32.bulk", "--seed", "1", "--seconds", "1", "--trace",
            "0"]
    for cwd in (root, tmp_path):
        out = subprocess.run(args, cwd=cwd, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0
        assert out.stdout.strip() == ""

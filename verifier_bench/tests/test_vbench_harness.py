"""The harness is driven by data: a new configuration, traffic, cell and
metric are new files found by name; and the trace reduction on a synthetic
profiler trace."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from verifier_bench import harness, trace

NEW_METRIC = '''"""lanes_a_batch: the lanes of each batch of the window."""


def read(run):
    return run.lanes / max(1, len(run.latency_s))
'''

DRIVE = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
from verifier_bench import harness
res, _ = harness.run_cell("extra.cell", 3, 0.01, False, device="cpu",
                          overrides={"batch": 4, "tampered_lanes": 2,
                                     "batches_cycled": 1})
print(json.dumps(res))
"""


def test_new_files_are_found_by_name(root, tmp_path):
    """A copy of the benchmark gains a configuration, a traffic, a cell and
    a metric as new files and one BENCHMARK.json entry each; no file the
    benchmark had is edited, and a run of the new cell reports the new
    metric."""
    shutil.copytree(root / "verifier_bench", tmp_path / "verifier_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(root / "halo2_plonky2_verifier_tpu_torch",
               tmp_path / "halo2_plonky2_verifier_tpu_torch")
    vb = tmp_path / "verifier_bench"
    before = {p: p.read_bytes() for p in vb.rglob("*") if p.is_file()}
    cfg = json.loads((vb / "configs" / "starky_fib_gl.json").read_text())
    cfg["name"] = "extra_config"
    (vb / "configs" / "extra_config.json").write_text(json.dumps(cfg))
    tr = json.loads((vb / "traffic" / "n32.bulk.json").read_text())
    (vb / "traffic" / "extra.traffic.json").write_text(json.dumps(tr))
    (vb / "workloads" / "extra.cell.json").write_text(json.dumps(
        {"config": "extra_config", "traffic": "extra.traffic", "batch": 4,
         "chips": 1, "why": "a cell added as files"}))
    (vb / "metrics" / "lanes_a_batch.py").write_text(NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "extra_config", "source": "x",
                             "file": "verifier_bench/configs/extra_config.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "extra.cell", "config": "extra_config",
                               "traffic": "extra.traffic", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "lanes_a_batch", "unit": "lanes",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["extra.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"]
    assert set(res["metrics"]) == {"proofs_per_s", "setup_s", "lanes_a_batch"}
    assert res["metrics"]["lanes_a_batch"]["value"] == 4


def test_cell_metrics_follow_benchmark_json(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        e2e = [n for n, _ in harness.cell_metrics(bench, w["name"], False)]
        layer = [n for n, _ in harness.cell_metrics(bench, w["name"], True)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for name in e2e + layer:
            assert callable(harness.reader(name))
    with pytest.raises(FileNotFoundError):
        harness.part("workloads", "no.such.cell")


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def synthetic():
    """Two batches in a 1000 us window.  Batch spans hold the program's
    spans; `two_to_one` nests in `verify_merkle_proofs`.  Each span's
    kernels are launched inside it; an annotation drawn on the device
    spans them all and must not count."""
    ev = [_x("vbench.window", "user_annotation", 0, 1000)]
    for b, base in enumerate((0, 500)):
        ev.append(_x("vbench.verify", "user_annotation", base, 300))
        ev.append(_x("get_stark_challenges", "user_annotation", base + 10, 40))
        ev.append(_x("verify_merkle_proofs", "user_annotation", base + 60,
                     100))
        ev.append(_x("two_to_one", "user_annotation", base + 100, 40))
        ev.append(_x("verify_merkle_proofs", "gpu_user_annotation",
                     base + 60, 400, tid=7))
        launches = [(base + 20, 10), (base + 70, 30), (base + 110, 50)]
        for k, (t, dur) in enumerate(launches):
            corr = 100 * b + k
            ev.append(_x("cudaLaunchKernel", "cuda_runtime", t, 2,
                         correlation=corr))
            ev.append(_x(f"kernel{k}", "kernel", base + 200 + 60 * k, dur,
                         tid=7, correlation=corr))
    ev.append(_x("Memcpy DtoH", "gpu_memcpy", 900, 50, tid=7))
    return ev


def test_synthetic_trace():
    tr = trace.parse(synthetic(), harness.WINDOW_SPAN, harness.BATCH_SPAN)
    assert tr.batches == 2
    run = harness.Run(traffic={"batch": 1}, geom=None,
                      trace=tr)
    read = {n: harness.reader(n)(run) for n in
            ("transcript_ms", "merkle_ms", "device_idle_share",
             "launches_per_batch")}
    assert read["transcript_ms"] == pytest.approx(0.010)       # 10 us
    assert read["merkle_ms"] == pytest.approx(0.080)           # 30 + 50 us
    # busy: 2 x (10 + 30 + 50) us of kernels + 50 us of copy, in 1000 us
    assert read["device_idle_share"] == pytest.approx(100 * (1 - 230 / 1000))
    assert read["launches_per_batch"] == 3
    bd = trace.breakdown(tr)
    assert sum(v for _, v in bd["device_ops"]) == pytest.approx(180e-6)
    assert sum(v for _, v in bd["idle_gaps"]) == pytest.approx(770e-6)

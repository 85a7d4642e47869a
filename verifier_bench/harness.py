"""One run of one cell: set-up, the measured window, the reference check,
the metrics.

Everything a cell is made of is found by name: the cell in
`workloads/<cell>.json` (its configuration, traffic and chips), the
configuration in `configs/<config>.json`, the traffic in
`traffic/<traffic>.json`, and each metric's reader in
`metrics/<metric>.py`; `BENCHMARK.json` at the checkout's root says which
metrics a cell reports.  A new cell, configuration, traffic or metric is a
new file.

The window is a closed loop with `in_flight` verifies: the next batch is
enqueued before the previous batch's verdicts are read back to the host.
It cycles over `batches_cycled` batches built on the device in set-up, and
ends at the first batch boundary after `seconds`, once every batch in
flight has returned.  With tracing on, `trace_batches` batches run under
`torch.profiler` before the window, between two synchronisations.
"""

import dataclasses
import importlib
import importlib.util
import json
import os
import tempfile
import time
from collections import deque
from pathlib import Path

import numpy as np

from . import proofs, trace as trace_mod, traffic as traffic_mod
from .reference import geometry as geometry_mod, verifier as reference

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "halo2_plonky2_verifier_tpu")
WINDOW_SPAN, BATCH_SPAN, WAIT_SPAN = ("vbench.window", "vbench.verify",
                                      "vbench.wait")


def read_json(path):
    with open(path) as f:
        return json.load(f)


def part(kind, name, suffix=".json"):
    """The file of a cell, configuration, traffic or metric, by name."""
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return path


def reader(name):
    """The `read(run)` function of the metric `name`."""
    path = part("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        "verifier_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench, cell, traced):
    """[(name, unit)] of the metrics `cell` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return [(m["name"], m["unit"]) for m in e2e]
    moves = {m["name"] for m in e2e}
    return [(m["name"], m["unit"]) for m in bench["per_layer"]
            if cell in m.get("workloads", ()) or ("workloads" not in m
                                          and m["moves"] in moves)]


def forbidden_modules(modules):
    """The top-level names of `modules` that are JAX or the JAX package,
    each name compared whole."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    traffic: dict
    geom: object
    setup_s: float = 0.0
    window_s: float = 0.0
    lanes: int = 0
    latency_s: list = dataclasses.field(default_factory=list)
    enqueue_s: list = dataclasses.field(default_factory=list)
    trace: object = None


# ----------------------------------------------------------------------------
# the program: build, batches, the window
# ----------------------------------------------------------------------------

def build_program(config, geom, **options):
    """(verify, ProofShape, stark, StarkConfig) of the program for a
    configuration, its starky config built from the file's numbers;
    `options` go to `build_verifier` (the control's `check_vanishing`).
    Raises ValueError where the program would not run as the file
    states."""
    from halo2_plonky2_verifier_tpu_torch import (build_verifier,
                                                  proof_shape)
    from halo2_plonky2_verifier_tpu_torch.utils.config import (FriConfig,
                                                               StarkConfig)
    mod, cls = config["program_stark"].split(":")
    stark = getattr(importlib.import_module(mod), cls)(geom.num_rows)
    sc = config["starky_config"]
    starky = StarkConfig(
        security_bits=sc["security_bits"], num_challenges=sc["num_challenges"],
        fri_config=FriConfig(
            rate_bits=sc["rate_bits"], cap_height=sc["cap_height"],
            proof_of_work_bits=sc["proof_of_work_bits"],
            reduction_strategy=tuple(sc["reduction_strategy"]),
            num_query_rounds=sc["num_query_rounds"]))
    if sc.get("preset") == "standard_fast_config" and \
            starky != StarkConfig.standard_fast_config():
        raise ValueError("the program's standard_fast_config differs from "
                         "the configuration file's numbers")
    shape = proof_shape(stark, starky, geom.degree_bits, geom.hasher)
    if (tuple(shape.reduction_arity_bits) != geom.reduction_arity_bits
            or shape.oracle_widths != geom.oracle_widths
            or shape.final_poly_len != geom.final_poly_len):
        raise ValueError(f"program shape {shape} differs from {geom}")
    verify = build_verifier(stark, starky, geom.degree_bits,
                            hasher=geom.hasher, transcript=geom.transcript,
                            **options)
    return verify, shape, stark, starky


def device_batch(distinct, plan_batch):
    """A cycled batch on the device: the distinct proofs gathered by lane,
    then the tampers written into their lanes."""
    import torch
    idx = torch.as_tensor(plan_batch["sources"], device=distinct.device)

    def take(t):
        return None if t is None else t.index_select(0, idx)

    kw = {}
    for f in dataclasses.fields(distinct):
        if f.name == "shape":
            continue
        v = getattr(distinct, f.name)
        kw[f.name] = [take(x) for x in v] if isinstance(v, list) else take(v)
    batch = dataclasses.replace(distinct, **kw)
    for lane, _, writes in plan_batch["tampers"]:
        for field, li, index, value in writes:
            t = getattr(batch, field)
            t = t if li is None else t[li]
            t[(lane,) + index] = int(np.array(value, dtype=np.uint64)
                                     .view(np.int64))
    return batch


def _loop(verify, batches, first, count, seconds, in_flight, on_done):
    """The closed loop: keep `in_flight` verifies enqueued; stop enqueuing
    after `count` batches or `seconds`; returns when every enqueued batch
    has returned.  `on_done(k, t_call, t_return, t_verdicts, verdicts)`."""
    import torch
    pending = deque()
    k = first
    start = time.perf_counter()
    while True:
        while (len(pending) < in_flight and k - first < count
               and time.perf_counter() - start < seconds):
            with torch.profiler.record_function(BATCH_SPAN):
                t_call = time.perf_counter()
                v = verify(batches[k % len(batches)])
                t_ret = time.perf_counter()
            pending.append((k, t_call, t_ret, v))
            k += 1
        if not pending:
            return k
        j, t_call, t_ret, v = pending.popleft()
        with torch.profiler.record_function(WAIT_SPAN):
            host = v.cpu().numpy()
        on_done(j, t_call, t_ret, time.perf_counter(), host)


def traced_batches(verify, batches, count, in_flight, on_done):
    """`count` batches under torch.profiler; returns the parsed Trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            _loop(verify, batches, 0, count, float("inf"), in_flight,
                  on_done)
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return trace_mod.load(path, WINDOW_SPAN, BATCH_SPAN)


# ----------------------------------------------------------------------------
# one run
# ----------------------------------------------------------------------------

def run_cell(workload, seed, seconds, traced, device="cuda", t0=None,
             overrides=None, make_verify=None, program_options=None,
             log=None):
    """One run of cell `workload`.  Returns (result, compared): the last
    line's object and [(name, value, limit)] of the numbers compared.
    `overrides` replaces traffic parameters (the batch sweep, the tests'
    small batches); `program_options` go to `build_verifier` (the control);
    `make_verify(verify)` wraps the program's verify (the planted
    faults)."""
    import torch
    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda *a: None)
    bench = read_json(HERE.parent / "BENCHMARK.json")
    cell = read_json(part("workloads", workload))
    config = read_json(part("configs", cell["config"]))
    traffic = {**read_json(part("traffic", cell["traffic"])),
               "batch": cell["batch"], **(overrides or {})}
    geom = geometry_mod.geometry(config, traffic["num_rows"])
    fields = proofs.load(HERE.parent / config["proofs"][str(geom.num_rows)],
                         geom)
    n_distinct = len(fields["pow_witness"])
    plan = traffic_mod.make_plan(seed, traffic, geom, fields)

    # set-up: the program, the distinct proofs on the device, the cycled
    # batches, one warm verify of each
    from halo2_plonky2_verifier_tpu_torch import witness
    verify, shape, _, _ = build_program(config, geom,
                                        **(program_options or {}))
    if make_verify is not None:
        verify = make_verify(verify)
    distinct = witness.batch_from_u64(fields, shape, device)
    batches = [device_batch(distinct, b) for b in plan]
    for b in batches:
        verify(b).cpu()
    if device != "cpu":
        torch.cuda.synchronize()
    run = Run(traffic=traffic, geom=geom)
    run.setup_s = time.perf_counter() - t0

    verdicts = []
    traced_lat = []

    def done(into):
        def on_done(k, t_call, t_ret, t_end, host):
            verdicts.append((k % len(batches), host))
            into.append((t_call, t_ret, t_end))
        return on_done

    if traced:
        run.trace = traced_batches(verify, batches, traffic["trace_batches"],
                                   traffic["in_flight"], done(traced_lat))
    timed = []
    start = time.perf_counter()
    _loop(verify, batches, 0, float("inf"), seconds, traffic["in_flight"],
          done(timed))
    run.window_s = time.perf_counter() - start
    run.lanes = len(timed) * traffic["batch"]
    run.latency_s = [c - a for a, _, c in timed]
    run.enqueue_s = [b - a for a, b, _ in timed]
    log(f"window: {len(timed)} batches of {traffic['batch']} in "
        f"{run.window_s:.3f} s")

    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if device != "cpu" else 0)}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_us() * 1e-6
        dev["window_s"] = (run.trace.window[1] - run.trace.window[0]) * 1e-6
    del batches, distinct
    if device != "cpu":
        torch.cuda.empty_cache()

    # the reference, on the host: every distinct proof and every tampered
    # lane, so every lane of the window has its reference verdict
    t_ref = time.perf_counter()
    ref = reference.verify_lanes(geom, traffic_mod.reference_lanes(plan,
                                                                   fields))
    exp = traffic_mod.expected(plan, ref, n_distinct)
    log(f"reference: {len(ref)} lanes in {time.perf_counter() - t_ref:.3f} s")
    attempted = sum(len(v) for _, v in verdicts)
    failed = int(sum(int((v != exp[c]).sum()) for c, v in verdicts))
    compared = [
        ("failed_lanes", failed, 0),
        ("reference_rejects_valid", int((~ref[:n_distinct]).sum()), 0),
        ("reference_accepts_tampered", int(ref[n_distinct:].sum()), 0),
        ("lanes_unanswered", 0 if attempted > 0 else 1, 0),
    ]
    correct = all(v <= lim for _, v, lim in compared)

    metrics = {}
    for name, unit in cell_metrics(bench, workload, traced):
        value = reader(name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        result["breakdown"] = trace_mod.breakdown(run.trace)
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in compared}
    return result, compared

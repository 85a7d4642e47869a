"""From a `torch.profiler` trace to what the per-layer readers need.

The trace is the profiler's Chrome JSON (`export_chrome_trace`).  Its
events, by category:

  kernel, gpu_memcpy, gpu_memset   device work, with its launch's
                                   `correlation` id
  cuda_runtime, cuda_driver        the host calls that launched it
                                   (`cudaLaunchKernel`, ...), same id
  user_annotation                  a host span: a `record_function` of the
                                   program (`utils/profiling.scope`) or of
                                   the benchmark
  gpu_user_annotation              the same span as drawn on the device:
                                   no device work of its own, never counted

A kernel belongs to the host spans that enclose its launch, on the
launching thread.  Device busy time is the union of the device intervals.
"""

import json
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    """Times in microseconds on the trace's clock."""
    kernels: list = field(default_factory=list)   # (name, ts, dur, launch ts, tid)
    device: list = field(default_factory=list)    # (ts, dur) of all device work
    spans: dict = field(default_factory=dict)     # name -> [(ts, end, tid)]
    window: tuple = (0.0, 0.0)                    # (start, end)
    batches: int = 0

    def spans_named(self, names):
        return [s for n in names for s in self.spans.get(n, [])]

    def kernel_us_in(self, names):
        """Device time of the kernels launched inside any span of `names`,
        each kernel counted once."""
        return float(self.kernel_dur[self.kernels_in(names)].sum())

    def kernels_in(self, names):
        """(kernels,) bool: launched inside a span of `names`."""
        mask = np.zeros(len(self.kernels), dtype=bool)
        by_tid = defaultdict(list)
        for ts, end, tid in self.spans_named(names):
            by_tid[tid].append((ts, end))
        for tid, ivs in by_tid.items():
            merged = _merge(ivs)
            starts = np.array([a for a, _ in merged])
            ends = np.array([b for _, b in merged])
            t = self.kernel_launch
            i = np.searchsorted(starts, t, side="right") - 1
            hit = (i >= 0) & (t < ends[np.maximum(i, 0)])
            mask |= hit & (self.kernel_tid == tid)
        return mask

    @property
    def kernel_dur(self):
        return np.array([k[2] for k in self.kernels], dtype=np.float64)

    @property
    def kernel_launch(self):
        return np.array([k[3] for k in self.kernels], dtype=np.float64)

    @property
    def kernel_tid(self):
        return np.array([-1 if k[4] is None else k[4] for k in self.kernels])

    def busy_us(self):
        return sum(e - s for s, e in _merge(
            [(ts, ts + dur) for ts, dur in self.device
             if ts < self.window[1] and ts + dur > self.window[0]],
            clip=self.window))

    def idle_gaps(self):
        """[(start, end)] of the window's stretches with no device work."""
        busy = _merge([(ts, ts + dur) for ts, dur in self.device],
                      clip=self.window)
        gaps, t = [], self.window[0]
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.window[1]:
            gaps.append((t, self.window[1]))
        return gaps

    def host_spans_at(self, times):
        """The innermost host span that holds each of `times`, or None."""
        times = np.asarray(times, dtype=np.float64)
        out = np.full(len(times), None, dtype=object)
        ivs = sorted(((e - s, s, e, name) for name, v in self.spans.items()
                      for s, e, _ in v), reverse=True)
        for _, s, e, name in ivs:          # the shortest span writes last
            out[(times >= s) & (times < e)] = name
        return out


def _merge(intervals, clip=None):
    out = []
    for s, e in sorted(intervals):
        if clip is not None:
            s, e = max(s, clip[0]), min(e, clip[1])
            if e <= s:
                continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def parse(events, window_span, batch_span):
    """A Trace of the Chrome trace `events`.  The window is the extent of
    the span named `window_span`; `batch_span` counts the batches in it."""
    tr = Trace()
    launches = {}
    raw_kernels = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "user_annotation":
            tr.spans.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"]))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(e["ts"]), e["tid"])
        elif cat in DEVICE_CATS:
            tr.device.append((float(e["ts"]), float(e["dur"])))
            if cat == "kernel":
                raw_kernels.append(e)
    for e in raw_kernels:
        lt, tid = launches.get(e.get("args", {}).get("correlation"),
                               (float("nan"), None))
        tr.kernels.append((e["name"], float(e["ts"]), float(e["dur"]), lt,
                           tid))
    win = tr.spans.get(window_span, [])
    if not win:
        raise ValueError(f"no span {window_span!r} in the trace")
    tr.window = (min(s for s, _, _ in win), max(e for _, e, _ in win))
    tr.batches = sum(1 for s, e, _ in tr.spans.get(batch_span, [])
                     if s >= tr.window[0] and e <= tr.window[1])
    return tr


def load(path, window_span, batch_span):
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return parse(events, window_span, batch_span)


def breakdown(tr, top=10):
    """{"device_ops": [[kernel, seconds]], "idle_gaps": [[host span,
    seconds]]}, each the `top` largest."""
    ops = defaultdict(float)
    for name, _, dur, _, _ in tr.kernels:
        ops[name[:160]] += dur * 1e-6
    gaps = defaultdict(float)
    idle = tr.idle_gaps()
    where = tr.host_spans_at([(s + e) / 2 for s, e in idle])
    for (s, e), name in zip(idle, where):
        gaps[name or "outside any span"] += (e - s) * 1e-6
    return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:top]}

"""Kernel times on the card, as `chip_smoke.py` and the probe tools take
them.

`cuda_ms` is the median of `reps` calls, each between its own pair of CUDA
events, all queued behind a sleep of the card so that a host that is held
up while it enqueues them (its cores may be shared) adds no idle time
inside a pair.  `host_ms` is the same on the host's clock, for a rehearsal
of a tool on the CPU; its times are the CPU's.  `SmiSampler` has
`nvidia-smi` sample the card's SM clock, power draw and temperature while a
block of code runs, for the clock beside a time.
"""

import statistics
import subprocess
import time
from datetime import datetime

import torch


def cuda_ms(fn, reps, warm_up=True):
    """Median milliseconds of one fn() on the card over `reps` calls, after
    one warm-up call unless `warm_up` is False.  Each call sits between its
    own pair of CUDA events, and all are queued behind a 10 ms sleep of the
    card; the median, so that one call held up all the same does not set
    the result."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(20_000_000)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def host_ms(fn, reps, warm_up=True):
    """Median milliseconds of one fn() on the host's clock over `reps`
    calls, after one warm-up call unless `warm_up` is False."""
    if warm_up:
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


SMI_FIELDS = "timestamp,clocks.sm,power.draw,temperature.gpu"


def smi_samples(path):
    """[(epoch s, SM MHz, W, deg C)] from `nvidia-smi --query-gpu=SMI_FIELDS
    --format=csv,noheader,nounits` output in the file `path`."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = [x.strip() for x in line.split(",")]
            if len(parts) != 4:
                continue
            try:
                t = datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f")
                rows.append((t.timestamp(), float(parts[1]),
                             float(parts[2]), float(parts[3])))
            except ValueError:
                continue
    return rows


class SmiSampler:
    """`nvidia-smi` writing SMI_FIELDS every 20 ms to the file `path` while
    the `with` block runs; `samples()` reads them once the block has ended
    (the tool buffers its output).  Entering waits `start_s` seconds, so
    that the block's first window is sampled."""

    def __init__(self, path, start_s=1.0):
        self.path, self.start_s = path, start_s
        self._proc = self._file = None

    def __enter__(self):
        self._file = open(self.path, "w")
        self._proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=self._file)
        time.sleep(self.start_s)
        return self

    def __exit__(self, *exc):
        try:
            self._proc.terminate()
            self._proc.wait(timeout=30)
        finally:
            self._file.close()

    def samples(self):
        return smi_samples(self.path)

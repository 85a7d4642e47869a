"""The launch sizing of the chained Goldilocks kernels K3 and K8
(`csrc/sized_launch.cuh`), built for the host by a C++ compiler against a
stand-in for the CUDA runtime calls it makes (`tests/sized_launch_host.cpp`):
the shapes it picks for any N, the card it reads, and its cache and error
paths.  No card is needed; the arithmetic is integers, compared exactly.
"""

import math
import shutil
import subprocess
from pathlib import Path

import pytest

from halo2_plonky2_verifier_tpu_torch.ops import _build

HOST_HARNESS = Path(__file__).resolve().parent / "sized_launch_host.cpp"
MAX_THREADS = 1024


@pytest.fixture(scope="module")
def sized(tmp_path_factory):
    """A function running the host build on records (device, sms,
    resident, status, n) -> [(status, threads, blocks, queries so far)]."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the launch sizing")
    out = tmp_path_factory.mktemp("sized_launch")
    (out / "cuda_runtime.h").write_text("")   # the harness declares its calls
    exe = out / "sized_launch_host"
    subprocess.run([cxx, "-std=c++17", "-O1", "-I", str(_build.CSRC), "-I",
                    str(out), "-o", str(exe), str(HOST_HARNESS)], check=True,
                   capture_output=True)

    def run(records):
        text = "\n".join(" ".join(map(str, r)) for r in records) + "\n"
        lines = subprocess.run([str(exe)], input=text, capture_output=True,
                               text=True, check=True).stdout.splitlines()
        return [tuple(int(w) for w in line.split()) for line in lines]

    return run


@pytest.mark.parametrize("sms,resident", [(132, 1), (132, 2), (114, 1)])
@pytest.mark.parametrize("n", [1, 31, 100, 132, 4097, 132 * 1024,
                               132 * 1024 + 1, 172_032, 172_033, 1 << 18,
                               (1 << 18) + 1, 688_128, 1 << 20, 1 << 21,
                               (1 << 31) + 5])
def test_launch_covers_n_in_the_fewest_equal_rounds(sized, n, sms, resident):
    """Blocks of whole multiples of four warps, at most MAX_THREADS, every
    lane covered and no block empty; as many rounds of blocks as MAX_THREADS
    a block would need, and with two rounds or more, every block more than
    half of MAX_THREADS and fewer than one slot in threads / 128 of all
    rounds left empty."""
    [(status, threads, blocks, _)] = sized([(0, sms, resident, 0, n)])
    assert status == 0
    assert threads % 128 == 0 and 128 <= threads <= MAX_THREADS
    assert blocks * threads >= n > (blocks - 1) * threads
    slots = sms * resident
    rounds = math.ceil(n / (slots * MAX_THREADS))
    assert math.ceil(blocks / slots) == rounds
    if rounds >= 2:
        assert threads > MAX_THREADS // 2
        assert (rounds * slots - blocks) * threads < rounds * slots * 128


def test_launch_of_the_drive_and_probe_shapes(sized):
    """K3 at the GL n=2^11 drive's step leaves: two rounds of 768-thread
    blocks (24 warps an SM) where 1024-thread ones would leave 36 of 168
    blocks to a second round; at B=4096, six rounds of 896; K8 at the
    chained probe: two rounds of 1024; fewer lanes than SMs: one block of
    four warps."""
    records = [(0, 132, 1, 0, n) for n in (172_032, 1 << 18, 100, 688_128)]
    assert [r[1:3] for r in sized(records)] == [
        (768, 224), (1024, 256), (128, 1), (896, 768)]


def test_card_is_read_once_per_device(sized):
    """The occupancy query runs at the first launch on a device and is
    cached; another device is queried on its own, with its own SMs."""
    got = sized([(0, 132, 1, 0, 172_032), (0, 132, 1, 0, 1 << 18),
                 (1, 66, 1, 0, 172_032), (1, 66, 1, 0, 5), (0, 7, 9, 0, 5)])
    assert [r[3] for r in got] == [1, 1, 2, 2, 2]
    assert got[2][1:3] == (896, 192)        # 3 rounds over 66 SMs
    assert got[4][1:3] == (128, 1)          # device 0's cache, not 7 SMs


def test_failed_query_returns_its_status_and_is_not_cached(sized):
    """A failed occupancy query returns its status and no shape; the next
    launch queries again.  A device past the cache's range, or a card that
    reports no room for a block, is refused."""
    got = sized([(0, 132, 1, 98, 1000), (0, 132, 1, 0, 1000),
                 (64, 132, 1, 0, 1000), (1, 132, 0, 0, 1000)])
    assert got[0] == (98, 0, 0, 1)
    assert got[1] == (0, 128, 8, 2)
    assert got[2][0] == 101                 # cudaErrorInvalidDevice
    assert got[3][0] == 9                   # cudaErrorInvalidConfiguration

"""The Goldilocks-multiply speed of light: kernel K10 beside its plain
PyTorch version.

K10, `mul_chain` (csrc/gl_mul_chain.cu), runs `chain` dependent products
x <- x * y mod p on every element with the element in registers.  It is not
a port of a Pallas kernel: the JAX package's probe
(`tools/sol_bench.py:measure_gl_mul_sol`) is a jit-fused `lax.scan` of
`gl.mul`, and in eager PyTorch the same loop would time one launch a
product.  `tools/torch_sol_bench.py:measure_gl_mul_sol` times it.

The wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor; there is no other switch.  It counts its launches in
`mul_chain.launches`.  Both record `chain` gl_mul a lane in an active op
census (`utils/profiling.py`), the plain version's own products not again.
"""

import torch

from ..utils import profiling
from . import _build
from . import goldilocks as gl
from .merkle_kernels import _check, _device
from .poseidon_kernels import _chain


def _census(x, y, chain):
    profiling.record("gl_mul", int(chain) * x.numel())


@profiling.counted(_census)
def mul_chain_plain(x, y, chain):
    """Plain K10: x, y int64 tensors of one shape -> x * y^chain mod p,
    canonical, by `chain` products `gl.mul` in a row; chain 0 returns a
    copy of x."""
    x = x.clone()
    for _ in range(chain):
        x = gl.mul(x, y)
    return x


@profiling.counted(_census)
def mul_chain(x, y, chain):
    """K10 wrapper: see `mul_chain_plain` for the contract; x and y
    contiguous int64 of one shape."""
    chain = _chain(chain)
    _check(x, "x", tuple(x.shape), torch.int64)
    _check(y, "y", tuple(x.shape), torch.int64)
    if _device(x, y).type == "cpu":
        return mul_chain_plain(x, y, chain)
    fn = _build.kernel("gl_mul_chain")
    out = torch.empty_like(x)
    status = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), chain,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("gl_mul_chain", status)
    mul_chain.launches += 1
    return out


mul_chain.launches = 0

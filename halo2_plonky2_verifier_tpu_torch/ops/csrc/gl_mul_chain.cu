// K10: the Goldilocks-multiply speed of light: `chain` dependent products
// x <- x * y mod p on every element, the element held in registers.
//
// Not a port of a Pallas kernel: the JAX probe it stands for,
// tools/sol_bench.py:measure_gl_mul_sol, is a jit-fused lax.scan of
// ops/goldilocks.py:mul, which XLA fuses into one loop; eager PyTorch would
// time one launch a product.  Its rate is the denominator of BASELINE.json's
// "Goldilocks muls/sec vs SOL".  Plain version and wrapper:
// ops/goldilocks_kernels.py:mul_chain_plain / mul_chain.
//
// Layout: x, y and out are n contiguous u64 (the probe's (8, N) planes, any
// shape), one thread an element.  Any u64 in; the output is canonical.
// chain = 0 copies x (lax.scan of length 0 returns its carry).
//
// The product is a 64 x 64 -> 128-bit one, the low word `a * b` and the
// high word __umul64hi (the card has no 64-bit multiplier: each is a few
// 32-bit IMADs), reduced by the body's own reduce128 (poseidon_gl.cuh, the
// steps of ops/goldilocks.py:reduce128), so the reduction the verifier's
// kernels run is what is measured.  Each thread's chain is serial, so the
// rate comes from the warps an SM holds: the launch is sized to the card as
// K3's and K8's (sized_launch.cuh), at most 1024 threads a block.
//
// Bound: 4 IMAD a product (utils/roofline.py GL_MUL), operations-bound for
// any chain above a few products; the bytes are one read of x and y and one
// write of out.

#include <cuda_runtime.h>

#include "poseidon_gl.cuh"
#include "sized_launch.cuh"

constexpr int MUL_CHAIN_THREADS = 1024;

__global__ void __launch_bounds__(MUL_CHAIN_THREADS, 1)
    gl_mul_chain_kernel(const uint64_t* __restrict__ x,
                        const uint64_t* __restrict__ y,
                        uint64_t* __restrict__ out, int64_t n, int chain) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t a = x[i];
  const uint64_t b = y[i];
#pragma unroll 4
  for (int c = 0; c < chain; ++c) a = gl::reduce128(__umul64hi(a, b), a * b);
  out[i] = a;
}

static CardCache card;

extern "C" int launch_gl_mul_chain(const void* x, const void* y, void* out,
                                   long long n, int chain, void* stream) {
  if (chain < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int threads;
    long long blocks;
    const cudaError_t e = sized_launch<MUL_CHAIN_THREADS>(
        card, gl_mul_chain_kernel, n, threads, blocks);
    if (e != cudaSuccess) {
      cudaGetLastError();   // clear it, so no later launch reports it
      return (int)e;
    }
    gl_mul_chain_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        (const uint64_t*)x, (const uint64_t*)y, (uint64_t*)out, (int64_t)n,
        chain);
  }
  return (int)cudaGetLastError();
}

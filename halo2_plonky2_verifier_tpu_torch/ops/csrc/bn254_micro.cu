// K9: component probes of the Poseidon-BN254 body and of the card's
// multipliers, the probe's id a launch argument.
//
// Replaces tools/bn254_micro.py:probe (inner kernel :45, pallas_call :70),
// which times CHAIN dependent iterations of the TPU kernel's own functions
// (_redc_mxu, _mix_mxu, its partial round on one state and on two, the
// permutation's tile sweep) and of 16 u32 or f32 products.  Plain version
// and wrapper: ops/bn254_micro_kernels.py:run_probe_plain / run_probe; the
// probes' table is there.
//
// Fr probes.  Each thread runs `chain` dependent iterations of one function
// of poseidon_bn254.cuh, the body K4-K6 run, on its own lane's state: the
// S-box's squaring with REDC, a Montgomery product, REDC alone, the S-box,
// a full round, a sparse partial round (on one state, and on two a thread),
// the permutation, and K6's four-lane permutation (one state over four
// lanes of a warp, the tables in shared memory as bn254_permute.cu copies
// them).  This file defines no Fr arithmetic.  Values stay lazy (< 2p)
// between iterations, as in K4, and are made canonical once, before the
// store: every body function keeps values below 2p, so the result is the
// canonical value the plain version reaches on canonical values.
// Iteration i runs full round i % 8 or partial round i % 56, so a chain
// walks the schedule's tables as the permutation does, and 8 full rounds
// and 56 partial rounds add up to one permutation.
//
// Multiplier probes.  Per lane, 16 dependent steps an iteration, from the
// input word: u32 x = (x (x ^ j)) & 0xFFFF | 1; f32 x = fmod(x (x + j + 1),
// 65536) + 1, the product rounded to nearest (__fmul_rn, so no contraction
// changes it) and fmod taken as v - floor(v 2^-16) 65536 (an FMUL, a floor
// and an FFMA, exact for these non-negative integer values; fmodf is a
// software routine of many instructions); wide x = hi32(x) c_j + x mod
// 2^64, an IMAD.WIDE.U32 with a 64-bit addend, the instruction the body's
// products are made of.  (With lo32(x) as the factor, ptxas runs the chain
// on the low word alone, IMAD.WIDE.U32 without an addend, and sums the high
// words apart with IADD3.X; with the high word as the factor each step
// needs the whole previous value.)  A thread interleaves the chains of K
// lanes (K = 1, 4 or 8), so that a scheduler has independent multiplies
// to issue when few threads are resident.
//
// Bound.  Every probe is bound by its operations (utils/roofline.py's
// multiplies at the published peak), not by its bytes (one read and one
// write of a lane's words for the whole chain), and none reaches it: what
// holds each is the rate its instructions issue and the pipes they share.
// The design makes each readable as such.  Each probe is its own template
// instance with its own register allocation, so its SASS census
// (tools/torch_bn254_tune.py) reads beside its time; the Fr probes chain
// the body's own functions, so their times add up against the
// permutation's; a multiplier probe's step is the few instructions of its
// census, and it runs at the whole card's occupancy (sized launch) with K
// chains a thread, so its time is the pipes' rate, not a chain's latency.
// Measured on an H100 SXM at 700 W (PERF.md §3, §6): the round probes'
// IMAD.WIDE.U32 issue at about 0.8 of the wide probe's rate, the whole
// permutation at about 0.5; ptxas follows each wide step with an IADD3 of
// a zero register, so that probe times the pair; the u32 step is an IMAD
// and two or three LOP3, the f32 step six FP32-pipe instructions, one a
// FRND.
// Launch: every probe through sized_launch.cuh (the fewest rounds of
// resident blocks that hold its threads, split evenly), the Fr probes under
// K4's budget of 128 registers a thread (__launch_bounds__(512, 1));
// `permute` also at fixed 128, 256 and 512 threads a block under the same
// budget, the counterpart of the TPU tile sweep.
//
// Layout: (rows, N) u64 planes, row 4 e + k = word k of Fr element e, or a
// multiplier probe's one word a lane; lanes are the fastest axis.

#include <cuda_runtime.h>

#include "poseidon_bn254.cuh"
#include "sized_launch.cuh"

enum Probe {
  SQR_REDC = 0,          // x <- x * x / R (the S-box's squaring stage)
  MONT_MUL = 1,          // x <- x * c / R, c = element 1, kept
  REDC = 2,              // x <- x / R
  SBOX = 3,              // x <- x^5
  FULL_ROUND = 4,        // s <- full round i % 8
  PARTIAL_ROUND = 5,     // s <- partial round i % 56 (the sparse mix)
  PARTIAL_ROUND_X2 = 6,  // the same on two states a thread
  PERMUTE = 7,           // s <- the permutation, one thread a state
  PERMUTE_GROUP4 = 8,    // the same over four lanes a state (K6's form)
  U32_MUL16 = 9,         // 16 x: x = (x * (x ^ j)) & 0xFFFF | 1
  F32_MUL16 = 10,        // 16 x: x = fmod(x * (x + j + 1), 65536) + 1
  WIDE_MUL16 = 11,       // 16 x: x = hi32(x) * c_j + x mod 2^64
  PROBES = 12,
};

constexpr int FR_THREADS = 512;          // 128 registers a thread
constexpr int MUL_THREADS = 1024;

// Fr elements a lane.
__host__ __device__ constexpr int probe_elems(int p) {
  return p == MONT_MUL ? 2
         : (p == SQR_REDC || p == REDC || p == SBOX) ? 1
         : p == PARTIAL_ROUND_X2 ? 8
         : 4;
}

// The wide probe's 32-bit constants, below 2^31.
__host__ __device__ constexpr uint32_t wide_c(int j) {
  return 0x1E3779B9u + 2u * (uint32_t)j;
}

template <int PROBE>
__device__ __forceinline__ void step(uint32_t (*s)[bn::NL], int i) {
  if constexpr (PROBE == SQR_REDC) {
    bn::mont_sqr(s[0], s[0]);
  } else if constexpr (PROBE == MONT_MUL) {
    bn::mont_mul(s[0], s[1], s[0]);
  } else if constexpr (PROBE == REDC) {
    bn::from_mont(s[0]);
  } else if constexpr (PROBE == SBOX) {
    bn::sbox(s[0]);
  } else if constexpr (PROBE == FULL_ROUND) {
    bn::full_round(s, i % bn::FULL);
  } else if constexpr (PROBE == PARTIAL_ROUND) {
    bn::partial_round(s, i % BN_PARTIAL_ROUNDS);
  } else if constexpr (PROBE == PARTIAL_ROUND_X2) {
    const int r = i % BN_PARTIAL_ROUNDS;
    bn::partial_round(s, r);
    bn::partial_round(s + bn::WIDTH, r);
  } else {
    bn::permute(s);
  }
}

// One thread a lane (every Fr probe but PERMUTE_GROUP4).
template <int PROBE, int THREADS>
__global__ void __launch_bounds__(THREADS, FR_THREADS / THREADS)
    bn254_micro_kernel(const uint64_t* __restrict__ in,
                       uint64_t* __restrict__ out, int64_t n, int chain) {
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= n) return;
  constexpr int E = probe_elems(PROBE);
  uint32_t s[E][bn::NL];
#pragma unroll
  for (int e = 0; e < E; ++e) bn::load(in + e * 4 * n + lane, n, s[e]);
#pragma unroll 1
  for (int i = 0; i < chain; ++i) step<PROBE>(s, i);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    bn::reduce(s[e], BN_P);
    bn::store(out + e * 4 * n + lane, n, s[e]);
  }
}

// Four lanes a state, lane e holding element e, as K6.  Every thread runs
// (the shuffles need whole warps): a group past the last state permutes a
// copy of state n - 1 and stores nothing.
__global__ void __launch_bounds__(FR_THREADS, 1)
    bn254_micro_group4_kernel(const uint64_t* __restrict__ in,
                              uint64_t* __restrict__ out, int64_t n,
                              int chain) {
  __shared__ bn::OptTables tables;
  bn::copy_tables(tables, threadIdx.x, blockDim.x);
  __syncthreads();
  const int64_t state = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) /
                        bn::WIDTH;
  const int e = threadIdx.x % bn::WIDTH;
  const int base = (threadIdx.x % 32) & ~(bn::WIDTH - 1);
  const int64_t lane = state < n ? state : n - 1;
  uint32_t x[bn::NL];
  bn::load(in + e * 4 * n + lane, n, x);
#pragma unroll 1
  for (int i = 0; i < chain; ++i) bn::permute_group4(x, e, base, tables);
  bn::reduce(x, BN_P);
  if (state < n) bn::store(out + e * 4 * n + lane, n, x);
}

// K lanes a thread: thread q runs lanes q + k * items (k < K) side by side;
// a lane past n - 1 (in the last k only) runs a copy of lane n - 1 and
// stores nothing.
template <int PROBE, int K>
__global__ void __launch_bounds__(MUL_THREADS, 1)
    bn254_micro_mul_kernel(const uint64_t* __restrict__ in,
                           uint64_t* __restrict__ out, int64_t n,
                           int64_t items, int chain) {
  const int64_t q = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (q >= items) return;
  uint64_t w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t lane = q + k * items;
    w[k] = in[lane < n ? lane : n - 1];
  }
  if constexpr (PROBE == U32_MUL16) {
    uint32_t x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = (uint32_t)(w[k] & 0xFFFF);
#pragma unroll 1
    for (int i = 0; i < chain; ++i) {
#pragma unroll
      for (uint32_t j = 0; j < 16; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) x[k] = ((x[k] * (x[k] ^ j)) & 0xFFFFu) | 1u;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = x[k];
  } else if constexpr (PROBE == F32_MUL16) {
    float x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = (float)(uint32_t)(w[k] & 0xFFFF);
#pragma unroll 1
    for (int i = 0; i < chain; ++i) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float v = __fmul_rn(x[k], x[k] + (float)(j + 1));
          x[k] = fmaf(-floorf(v * 0x1p-16f), 65536.0f, v) + 1.0f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = (uint64_t)x[k];
  } else {
#pragma unroll 1
    for (int i = 0; i < chain; ++i) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          w[k] = (uint64_t)(uint32_t)(w[k] >> 32) * wide_c(j) + w[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (q + k * items < n) out[q + k * items] = w[k];
  }
}

// The sized launches' caches, one a kernel instance.
static CardCache fr_cards[PROBES];
static CardCache mul_cards[3][3];

// Launch `kernel` over `items` threads sized to the card; `shape`, if not
// null, gets its threads and blocks.
template <int MAX_THREADS, typename Kernel, typename... Args>
static int sized(CardCache& card, Kernel kernel, long long items,
                 cudaStream_t stream, long long* shape, Args... args) {
  int threads;
  long long blocks;
  const cudaError_t e =
      sized_launch<MAX_THREADS>(card, kernel, items, threads, blocks);
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it, so no later launch reports it
    return (int)e;
  }
  kernel<<<(unsigned)blocks, threads, 0, stream>>>(args...);
  if (shape) {
    shape[0] = threads;
    shape[1] = blocks;
  }
  return (int)cudaGetLastError();
}

template <int PROBE>
static int fr_sized(const uint64_t* in, uint64_t* out, long long n,
                    int chain, cudaStream_t s, long long* shape) {
  return sized<FR_THREADS>(fr_cards[PROBE],
                           bn254_micro_kernel<PROBE, FR_THREADS>, n, s,
                           shape, in, out, (int64_t)n, chain);
}

template <int THREADS>
static int permute_fixed(const uint64_t* in, uint64_t* out, long long n,
                         int chain, cudaStream_t s, long long* shape) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  bn254_micro_kernel<PERMUTE, THREADS><<<(unsigned)blocks, THREADS, 0, s>>>(
      in, out, (int64_t)n, chain);
  if (shape) {
    shape[0] = THREADS;
    shape[1] = blocks;
  }
  return (int)cudaGetLastError();
}

template <int PROBE>
static int mul_sized(int k, const uint64_t* in, uint64_t* out, long long n,
                     int chain, cudaStream_t s, long long* shape) {
  const long long items = (n + k - 1) / k;
  CardCache* cards = mul_cards[PROBE - U32_MUL16];
  if (k == 1)
    return sized<MUL_THREADS>(cards[0], bn254_micro_mul_kernel<PROBE, 1>,
                              items, s, shape, in, out, (int64_t)n,
                              (int64_t)items, chain);
  if (k == 4)
    return sized<MUL_THREADS>(cards[1], bn254_micro_mul_kernel<PROBE, 4>,
                              items, s, shape, in, out, (int64_t)n,
                              (int64_t)items, chain);
  return sized<MUL_THREADS>(cards[2], bn254_micro_mul_kernel<PROBE, 8>,
                            items, s, shape, in, out, (int64_t)n,
                            (int64_t)items, chain);
}

// threads: 0 sizes the launch to the card; PERMUTE also takes a fixed 128,
// 256 or 512.  k: lanes a thread, 1 for the Fr probes, 1, 4 or 8 for the
// multiplier probes.  shape, if not null, gets the launch's threads and
// blocks (0 and 0 for n = 0).
extern "C" int launch_bn254_micro(const void* in, void* out, int probe,
                                  int chain, long long n, int threads, int k,
                                  long long* shape, void* stream) {
  if (chain < 0 || n < 0 || probe < 0 || probe >= PROBES)
    return (int)cudaErrorInvalidValue;
  if (threads != 0 && !(probe == PERMUTE && (threads == 128 ||
                                             threads == 256 ||
                                             threads == 512)))
    return (int)cudaErrorInvalidValue;
  if (probe >= U32_MUL16 ? (k != 1 && k != 4 && k != 8) : k != 1)
    return (int)cudaErrorInvalidValue;
  if (shape) shape[0] = shape[1] = 0;
  if (n == 0) return (int)cudaGetLastError();
  const uint64_t* x = (const uint64_t*)in;
  uint64_t* y = (uint64_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (probe) {
    case SQR_REDC: return fr_sized<SQR_REDC>(x, y, n, chain, s, shape);
    case MONT_MUL: return fr_sized<MONT_MUL>(x, y, n, chain, s, shape);
    case REDC: return fr_sized<REDC>(x, y, n, chain, s, shape);
    case SBOX: return fr_sized<SBOX>(x, y, n, chain, s, shape);
    case FULL_ROUND: return fr_sized<FULL_ROUND>(x, y, n, chain, s, shape);
    case PARTIAL_ROUND:
      return fr_sized<PARTIAL_ROUND>(x, y, n, chain, s, shape);
    case PARTIAL_ROUND_X2:
      return fr_sized<PARTIAL_ROUND_X2>(x, y, n, chain, s, shape);
    case PERMUTE:
      if (threads == 128) return permute_fixed<128>(x, y, n, chain, s, shape);
      if (threads == 256) return permute_fixed<256>(x, y, n, chain, s, shape);
      if (threads == 512) return permute_fixed<512>(x, y, n, chain, s, shape);
      return fr_sized<PERMUTE>(x, y, n, chain, s, shape);
    case PERMUTE_GROUP4:
      return sized<FR_THREADS>(fr_cards[PERMUTE_GROUP4],
                               bn254_micro_group4_kernel, 4 * n, s, shape,
                               x, y, (int64_t)n, chain);
    case U32_MUL16: return mul_sized<U32_MUL16>(k, x, y, n, chain, s, shape);
    case F32_MUL16: return mul_sized<F32_MUL16>(k, x, y, n, chain, s, shape);
    default: return mul_sized<WIDE_MUL16>(k, x, y, n, chain, s, shape);
  }
}

// The BN254 kernels' body (halo2_plonky2_verifier_tpu_torch/ops/csrc/
// poseidon_bn254.cuh) built for the host, where its carry-flag primitives
// are plain C++, for tests/test_torch_bn254_opt.py.
//
// Reads "mode n" and then n records of Fr values (four u64 words each, in
// decimal) on stdin; writes each result's words on a line of stdout.
//   mont_mul   a b -> mont_mul(a, b), lazy
//   mont_sqr   a   -> mont_sqr(a), lazy
//   to_mont    x   -> to_mont(x), lazy
//   from_mont  x   -> from_mont(x), canonical
//   permute    s0 s1 s2 s3 -> permute, then canonical (one thread, K4/K5/K9)
//   group      s0 s1 s2 s3 -> permute_group4, then canonical (K6)
//   leaf       w g0 .. g(w-1) -> leaf_hash of the w Goldilocks words, then
//              canonical (one thread, K5)
// In the group mode four coroutines on one host thread are the four lanes,
// and __shfl_sync meets them at a barrier.
// Build: g++ -std=c++20 -I <csrc> -I <dir of the generated constants
// headers> bn254_body_host.cpp
#include <ucontext.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <functional>
#include <string>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
using std::min;
// The lanes of one group run as coroutines on one host thread, in turn: a
// shuffle writes the lane's value, passes control to the next lane, and
// reads once every lane has written (a barrier, met in lane order).  One
// thread keeps the test fast on a busy host, where threads that meet at a
// barrier wait for each other's time slices.
constexpr int LANES = 4;
static ucontext_t emu_main, emu_ctx[LANES];
static int emu_lane = 0;
static uint32_t emu_slot[32];
static void emu_barrier() {
  const int me = emu_lane;
  emu_lane = (me + 1) % LANES;
  swapcontext(&emu_ctx[me], &emu_ctx[emu_lane]);
}
uint32_t __shfl_sync(unsigned, uint32_t v, int src) {
  emu_slot[emu_lane] = v;
  emu_barrier();
  uint32_t r = emu_slot[src];
  emu_barrier();
  return r;
}
uint32_t __shfl_xor_sync(unsigned m, uint32_t v, int d) {
  return __shfl_sync(m, v, emu_lane ^ d);
}
#include "poseidon_bn254.cuh"

// Run lane_fn(e) for e < 4 as the four coroutine lanes of one group.
static std::function<void(int)> emu_fn;
static void lane_main() {
  const int l = emu_lane;
  emu_fn(l);
  // lanes finish in order; the last one returns to the caller
  emu_lane = l + 1;
  setcontext(l + 1 < LANES ? &emu_ctx[l + 1] : &emu_main);
}
static void run_group(std::function<void(int)> lane_fn) {
  static std::vector<char> stacks(LANES * (1 << 18));
  emu_fn = std::move(lane_fn);
  for (int l = 0; l < LANES; ++l) {
    getcontext(&emu_ctx[l]);
    emu_ctx[l].uc_stack.ss_sp = stacks.data() + l * (1 << 18);
    emu_ctx[l].uc_stack.ss_size = 1 << 18;
    emu_ctx[l].uc_link = &emu_main;
    makecontext(&emu_ctx[l], lane_main, 0);
  }
  emu_lane = 0;
  swapcontext(&emu_main, &emu_ctx[0]);
}

static void rd(uint32_t x[bn::NL]) {
  unsigned long long w[4];
  for (int k = 0; k < 4; ++k) scanf("%llu", &w[k]);
  bn::load((const uint64_t*)w, 1, x);
}
static void wr(const uint32_t x[bn::NL]) {
  uint64_t w[4];
  bn::store(w, 1, x);
  for (int k = 0; k < 4; ++k) printf("%llu ", (unsigned long long)w[k]);
}

int main() {
  char mode[32];
  long n;
  if (scanf("%31s %ld", mode, &n) != 2) return 2;
  static bn::OptTables tables;
  bn::copy_tables(tables, 0, 1);
  std::string m(mode);
  for (long q = 0; q < n; ++q) {
    if (m == "mont_mul") {
      uint32_t a[bn::NL], b[bn::NL], r[bn::NL];
      rd(a); rd(b);
      bn::mont_mul(a, b, r);
      wr(r);
    } else if (m == "mont_sqr") {
      uint32_t a[bn::NL];
      rd(a); bn::mont_sqr(a, a); wr(a);
    } else if (m == "to_mont") {
      uint32_t a[bn::NL];
      rd(a); bn::to_mont(a); wr(a);
    } else if (m == "from_mont") {
      uint32_t a[bn::NL];
      rd(a); bn::from_mont(a); wr(a);
    } else if (m == "permute") {
      uint32_t s[4][bn::NL];
      for (int e = 0; e < 4; ++e) rd(s[e]);
      bn::permute(s);
      bn::canonical(s);
      for (int e = 0; e < 4; ++e) wr(s[e]);
    } else if (m == "group") {
      uint32_t s[4][bn::NL];
      for (int e = 0; e < 4; ++e) rd(s[e]);
      run_group([&](int e) {
        bn::permute_group4(s[e], e, 0, tables);
        bn::reduce(s[e], BN_P);
      });
      for (int e = 0; e < 4; ++e) wr(s[e]);
    } else if (m == "leaf") {
      int w = 0;
      if (scanf("%d", &w) != 1) return 2;
      std::vector<uint64_t> words(w);
      for (auto& v : words) {
        unsigned long long u;
        if (scanf("%llu", &u) != 1) return 2;
        v = u;
      }
      uint32_t h[bn::NL];
      bn::leaf_hash(words.data(), 1, w, h);
      bn::reduce(h, BN_P);
      wr(h);
    } else {
      return 3;
    }
    printf("\n");
  }
  return 0;
}

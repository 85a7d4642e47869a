// The BN254 kernels' body (halo2_plonky2_verifier_tpu_torch/ops/csrc/
// poseidon_bn254.cuh) built for the host, where its carry-flag primitives
// are plain C++, for tests/test_torch_bn254_opt.py.
//
// Reads "mode n" and then n records of Fr values (four u64 words each, in
// decimal) on stdin; writes each result's words on a line of stdout.
//   mont_mul   a b -> mont_mul(a, b), lazy
//   to_mont    x   -> to_mont(x), lazy
//   from_mont  x   -> from_mont(x), canonical
//   permute    s0 s1 s2 s3 -> permute, then canonical (one thread, K4/K5/K9)
//   group      s0 s1 s2 s3 -> permute_group4, then canonical (K6): four
//              host threads are the four lanes, and __shfl_sync meets them
//              at a barrier.
// Build: g++ -std=c++20 -pthread -I <csrc> -I <dir of the generated
// constants headers> bn254_body_host.cpp
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <string>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
thread_local int emu_lane = 0;
static uint32_t emu_slot[32];
static std::barrier<>* emu_bar = nullptr;
uint32_t __shfl_sync(unsigned, uint32_t v, int src) {
  emu_slot[emu_lane] = v;
  emu_bar->arrive_and_wait();
  uint32_t r = emu_slot[src];
  emu_bar->arrive_and_wait();
  return r;
}
uint32_t __shfl_xor_sync(unsigned m, uint32_t v, int d) {
  return __shfl_sync(m, v, emu_lane ^ d);
}
#include "poseidon_bn254.cuh"

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
      std::barrier<> bar(4);
      emu_bar = &bar;
      std::vector<std::thread> th;
      for (int e = 0; e < 4; ++e)
        th.emplace_back([&, e] {
          emu_lane = e;
          bn::permute_group4(s[e], e, 0, tables);
          bn::reduce(s[e], BN_P);
        });
      for (auto& t : th) t.join();
      for (int e = 0; e < 4; ++e) wr(s[e]);
    } else {
      return 3;
    }
    printf("\n");
  }
  return 0;
}

// The Goldilocks kernels' body (halo2_plonky2_verifier_tpu_torch/ops/csrc/
// poseidon_gl.cuh) built for the host, where its PTX carry chains run the
// same steps in plain C++ and the 32 x 32 -> 64 products are the same, for
// tests/test_torch_gl_opt.py.
//
// Reads "mode n" and then n records of u64 values (decimal) on stdin; writes
// each result's values on a line of stdout.
//   reduce   hi lo -> (hi * 2^64 + lo) mod p, canonical (reduce128_lazy,
//            then canonicalize)
//   mul      a b c -> (a * b + c) mod p, canonical (mul_add_wide and
//            reduce128_lazy, then canonicalize)
//   sqr      a     -> a^2 mod p, canonical (sqr_wide)
//   sbox     a     -> a^7 mod p, canonical
//   dot      x0..x11 c0..c11 -> sum x_k c_k mod p (Acc, acc_reduce)
//   mds      s0..s11 -> M s (lazy rows), then canonical
//   permute  s0..s11 -> poseidon_gl_permute (one thread: K1, K3, K7, K8)
//   group4 / group16
//            s0..s11 -> permute_group<4 or 16> (K2): that many
//            coroutines on one host thread are the lanes of one group, and
//            __shfl_sync meets them at a barrier.
//   sponge   w g0 .. g(w-1) -> leaf_sponge of the w words: the leaf's
//            4-word hash (one thread, K3)
// Build: g++ -std=c++20 -I <csrc> -I <dir of the generated
// constants header> gl_body_host.cpp
#include <ucontext.h>

#include <cstdint>
#include <cstdio>
#include <string>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
// The lanes of one group run as coroutines on one host thread, in turn: a
// shuffle writes the lane's value, passes control to the next lane, and
// reads once every lane has written (a barrier, met in lane order).  One
// thread keeps the test fast on a busy host, where threads that meet at a
// barrier wait for each other's time slices.
static ucontext_t emu_main, emu_ctx[32];
static int emu_lanes = 0, emu_lane = 0;
static uint32_t emu_slot[32];
static void emu_barrier() {
  const int me = emu_lane;
  emu_lane = (me + 1) % emu_lanes;
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
#include "poseidon_gl.cuh"

static uint64_t rd() {
  unsigned long long v;
  if (scanf("%llu", &v) != 1) return 0;
  return v;
}
static void wr(uint64_t v) { printf("%llu ", (unsigned long long)v); }

template <int G>
struct GroupRun {
  uint64_t* s;
  const gl::GroupTables* t;
  uint64_t out[gl::W];
};
static void* emu_run = nullptr;

template <int G>
static void lane_main() {
  constexpr int E = gl::Group<G>::E;
  auto& run = *static_cast<GroupRun<G>*>(emu_run);
  const int l = emu_lane;
  const int e0 = gl::Group<G>::first_element(l);
  uint64_t x[E];
  for (int j = 0; j < E; ++j) x[j] = run.s[e0 + j];
  gl::permute_group<G>(x, l, 0, *run.t);
  if (gl::Group<G>::owns(l))
    for (int j = 0; j < E; ++j) run.out[e0 + j] = x[j];
  // lanes finish in order; the last one returns to the caller
  emu_lane = l + 1;
  setcontext(l + 1 < G ? &emu_ctx[l + 1] : &emu_main);
}

template <int G>
static void group(uint64_t s[gl::W], const gl::GroupTables& t) {
  static std::vector<char> stacks(G * (1 << 18));
  GroupRun<G> run{s, &t, {}};
  emu_run = &run;
  emu_lanes = G;
  for (int l = 0; l < G; ++l) {
    getcontext(&emu_ctx[l]);
    emu_ctx[l].uc_stack.ss_sp = stacks.data() + l * (1 << 18);
    emu_ctx[l].uc_stack.ss_size = 1 << 18;
    emu_ctx[l].uc_link = &emu_main;
    makecontext(&emu_ctx[l], lane_main<G>, 0);
  }
  emu_lane = 0;
  swapcontext(&emu_main, &emu_ctx[0]);
  for (int e = 0; e < gl::W; ++e) s[e] = run.out[e];
}

int main() {
  char mode[32];
  long n;
  if (scanf("%31s %ld", mode, &n) != 2) return 2;
  static gl::GroupTables tables;
  gl::copy_group_tables(tables, 0, 1);
  const std::string m(mode);
  for (long q = 0; q < n; ++q) {
    if (m == "reduce") {
      const uint64_t hi = rd(), lo = rd();
      wr(gl::canonicalize(gl::reduce128_lazy(hi, lo)));
    } else if (m == "mul") {
      const uint64_t a = rd(), b = rd(), c = rd();
      uint64_t hi, lo;
      gl::mul_add_wide(a, b, c, hi, lo);
      wr(gl::canonicalize(gl::reduce128_lazy(hi, lo)));
    } else if (m == "sqr") {
      wr(gl::canonicalize(gl::sqr_lazy(rd())));
    } else if (m == "sbox") {
      wr(gl::canonicalize(gl::sbox(rd())));
    } else if (m == "dot") {
      uint64_t x[gl::W];
      for (auto& v : x) v = rd();
      gl::Acc a = {0, 0, 0};
      for (int k = 0; k < gl::W; ++k) gl::acc_mul(a, x[k], rd());
      wr(gl::acc_reduce(a));
    } else if (m == "sponge") {
      const int w = (int)rd();
      std::vector<uint64_t> words(w);
      for (auto& v : words) v = rd();
      uint64_t h[4];
      gl::leaf_sponge(words.data(), 1, 0, w, h);
      for (auto v : h) wr(v);
    } else {
      uint64_t s[gl::W];
      for (auto& v : s) v = rd();
      if (m == "mds") {
        gl::mds(s);
        for (auto& v : s) v = gl::canonicalize(v);
      } else if (m == "permute") {
        gl::poseidon_gl_permute(s);
      } else if (m == "group4") {
        group<4>(s, tables);
      } else if (m == "group16") {
        group<16>(s, tables);
      } else {
        return 3;
      }
      for (auto v : s) wr(v);
    }
    printf("\n");
  }
  return 0;
}

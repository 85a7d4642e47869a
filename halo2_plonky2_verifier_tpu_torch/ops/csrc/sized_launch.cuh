// A launch sized to the card, for kernels that run a long dependent chain a
// thread (K3: ceil(w / 8) permutations a leaf, K8: `chain` permutations a
// state), one lane a thread.
//
// Blocks that fill the card in rounds leave a tail: with b blocks for s
// slots (SMs x resident blocks), the last round holds b mod s of them, and
// every SM without one idles for a whole chain.  The one-thread Goldilocks
// body saturates an SM's issue rate at about 16 warps (PERF.md §6: K7 at
// 2^17 ran two rounds of 16 warps as fast as one of 32), so a round of
// fewer warps wastes the rest of its SMs' time.  The launch therefore
// takes the fewest rounds that hold n lanes at MAX_THREADS a block, and
// splits the lanes evenly over them: blocks = rounds x slots (less a few in
// the last round), each of the fewest multiples of four warps that hold n
// over that many blocks, so that the SM's four schedulers get the same
// warps (K3 at n = 172,032 ran 3-6% faster at 768 threads than at 672,
// the same rounds).  Every SM then runs the same number of rounds, and with two
// rounds or more every round holds more than half of MAX_THREADS an SM (at
// 1024, more than 16 warps).  Example: n = 172,032 on 132 SMs at one block
// of 1024 an SM takes 2 rounds of 224 blocks of 768 threads, where 168
// blocks of 1024 take 2 rounds for 1.27 rounds of work (PERF.md §6).
//
// The SM count (cudaDevAttrMultiProcessorCount) and the resident blocks of
// MAX_THREADS (cudaOccupancyMaxActiveBlocksPerMultiprocessor) are read once
// per device and kept in the caller's CardCache; a failed query returns its
// status, and no launch is made.

#pragma once

#include <atomic>

#include <cuda_runtime.h>

struct CardCache {
  static constexpr int DEVICES = 64;
  std::atomic<int> sms[DEVICES];
  std::atomic<int> resident[DEVICES];
};

// (threads, blocks) of `kernel`'s launch over n >= 1 lanes at most
// MAX_THREADS a block (a multiple of 128, the kernel's launch bound).
template <int MAX_THREADS, typename Kernel>
cudaError_t sized_launch(CardCache& cache, Kernel kernel, long long n,
                         int& threads, long long& blocks) {
  static_assert(MAX_THREADS % 128 == 0, "a block is four warps a time");
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= CardCache::DEVICES) return cudaErrorInvalidDevice;
  int sms = cache.sms[dev].load(std::memory_order_relaxed);
  int resident = cache.resident[dev].load(std::memory_order_relaxed);
  if (sms == 0 || resident == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                      MAX_THREADS, 0);
    if (e != cudaSuccess) return e;
    if (sms < 1 || resident < 1) return cudaErrorInvalidConfiguration;
    cache.sms[dev].store(sms, std::memory_order_relaxed);
    cache.resident[dev].store(resident, std::memory_order_relaxed);
  }
  const long long slots = (long long)sms * resident;
  const long long per_round = slots * MAX_THREADS;
  const long long rounds = (n + per_round - 1) / per_round;
  const long long lanes = (n + rounds * slots - 1) / (rounds * slots);
  threads = (int)((lanes + 127) / 128 * 128);
  blocks = (n + threads - 1) / threads;
  return cudaSuccess;
}

// The launch sizing of K3 and K8 (halo2_plonky2_verifier_tpu_torch/ops/csrc/
// sized_launch.cuh) built for the host against a stand-in for the three
// CUDA runtime calls it makes, for tests/test_torch_sized_launch.py.
//
// Reads records "device sms resident status n" on stdin (the card the
// stand-in reports, and the status its occupancy query returns) and writes
// for each "status threads blocks queries" at MAX_THREADS = 1024, where
// queries counts the occupancy queries made so far.
// Build: g++ -std=c++17 -I <csrc> -I <dir holding an empty cuda_runtime.h>
// sized_launch_host.cpp
#include <cstdio>

typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidConfiguration = 9;
constexpr cudaError_t cudaErrorInvalidDevice = 101;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

static int card_device, card_sms, card_resident, card_status, queries;

cudaError_t cudaGetDevice(int* dev) {
  *dev = card_device;
  return cudaSuccess;
}
cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? card_sms : 0;
  return cudaSuccess;
}
template <typename Kernel>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, Kernel,
                                                          int, int) {
  ++queries;
  *blocks = card_resident;
  return card_status;
}

#include "sized_launch.cuh"

static void kernel() {}

int main() {
  static CardCache cache;
  long long n;
  while (scanf("%d %d %d %d %lld", &card_device, &card_sms, &card_resident,
               &card_status, &n) == 5) {
    int threads = 0;
    long long blocks = 0;
    const cudaError_t e = sized_launch<1024>(cache, kernel, n, threads,
                                             blocks);
    printf("%d %d %lld %d\n", e, threads, blocks, queries);
  }
  return 0;
}

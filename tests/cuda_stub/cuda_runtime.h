// CPU stand-in for the CUDA runtime, for compiling a kernel source with g++
// and running it on CPU tensors (tests/test_torch_port_pair_stub.py). Each
// block runs as one std::thread per CUDA thread, blocks one after another;
// `stub_launch(kernel, grid, threads, smem, args...)` replaces the
// <<<...>>> launch. Shared memory is a per-block buffer filled with 0xff
// (a bf16 NaN), so a read of unwritten shared memory shows in the output.
// Accesses through the PTX stubs (wgmma.cuh) are checked against that
// buffer and against the global tensors registered with sim_register.
#pragma once
#include <algorithm>
#include <barrier>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

struct dim3s { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3s threadIdx, blockIdx;
inline dim3s gridDim, blockDim;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }

struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
using std::max;
using std::min;
template <class T> inline T __shfl_sync(unsigned, T v, int) { return v; }

namespace sim {
[[noreturn]] inline void die(const char* what, long long a = 0, long long b = 0) {
  std::fprintf(stderr, "SIM FAULT: %s (%lld, %lld) block %u thread %u\n", what, a, b, blockIdx.x, threadIdx.x);
  std::fflush(stderr);
  std::abort();
}
struct Bar { int count = 0, pending = 0; long long tx = 0; unsigned phase = 0; };
struct Block {
  std::vector<unsigned char> smem;
  std::unique_ptr<std::barrier<>> sync;
  std::mutex mu;
  std::condition_variable cv;
  std::map<unsigned, Bar> bars;
  std::map<unsigned, std::unique_ptr<std::barrier<>>> named;
};
inline thread_local Block* cur = nullptr;
inline std::vector<std::pair<const unsigned char*, size_t>> ranges;
inline void check_global(const void* p, size_t n) {
  auto q = static_cast<const unsigned char*>(p);
  for (auto& r : ranges)
    if (q >= r.first && q + n <= r.first + r.second) return;
  die("global read outside the registered tensors");
}
inline void check_smem(const void* p, size_t n) {
  auto q = static_cast<const unsigned char*>(p);
  if (q < cur->smem.data() || q + n > cur->smem.data() + cur->smem.size())
    die("shared access outside the block's buffer", (long long)(q - cur->smem.data()), (long long)n);
}
inline int threads_per_block = 0;
}  // namespace sim

inline void __syncthreads() { sim::cur->sync->arrive_and_wait(); }
inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<const unsigned char*>(p) - sim::cur->smem.data();
}

template <class K, class... A>
void stub_launch(K kernel, unsigned grid, int threads, size_t smem, const A&... params) {
  gridDim.x = grid;
  blockDim.x = threads;
  for (unsigned b = 0; b < grid; ++b) {
    sim::Block blk;
    blk.smem.assign(smem, 0xff);  // unwritten shared memory reads as bf16 NaN
    blk.sync = std::make_unique<std::barrier<>>(threads);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        sim::cur = &blk;
        kernel(params...);
      });
    for (auto& t : ts) t.join();
  }
}

extern "C" __attribute__((used)) void sim_register(const void* p, long long n) {
  sim::ranges.emplace_back(static_cast<const unsigned char*>(p), (size_t)n);
}
extern "C" __attribute__((used)) void sim_clear() { sim::ranges.clear(); }

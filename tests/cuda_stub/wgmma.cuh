// Stub of ecm_torch/csrc/wgmma.cuh for running a kernel on the CPU (see
// cuda_runtime.h here). Every instruction is synchronous: wgmma computes the
// calling thread's accumulator entries at once, reading each operand element
// through its descriptor (start + (r/8)*SBO + (k/8)*LBO + (r%8)*16 +
// (k%8)*2), so a wrong descriptor shows; cp.async, TMA and bulk copies copy
// at once (TMA zero-fills outside the tensor map's extent) and complete
// their bytes on the mbarrier; mbarriers are (count, pending, tx, phase)
// under the block's mutex, a phase completing when no arrival and no byte is
// pending; a wait that lasts 300 s aborts (a deadlock). Fences, commits and
// group waits do nothing.
#pragma once
#include <cuda_runtime.h>
#include <cuda.h>
#include <cstdint>

namespace ecm {
namespace ptx {

inline unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

inline void cp_async16(void* dst, const void* src, bool valid) {
  sim::check_smem(dst, 16);
  if (valid) {
    sim::check_global(src, 16);
    std::memcpy(dst, src, 16);
  } else {
    std::memset(dst, 0, 16);
  }
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
inline void cp_async_wait_all() {}

inline uint64_t wgmma_desc(const void* smem, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_addr(smem) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N> inline void wgmma_wait() {}
inline void fence_operand(float&) {}

inline float operand(uint64_t desc, int r, int k) {
  const size_t start = (desc & 0x3FFF) << 4, lbo = ((desc >> 16) & 0x3FFF) << 4,
               sbo = ((desc >> 32) & 0x3FFF) << 4;
  const size_t off = start + (r / 8) * sbo + (k / 8) * lbo + (r % 8) * 16 + (k % 8) * 2;
  if (desc >> 46) sim::die("descriptor bits above the stride field");
  if (off + 2 > sim::cur->smem.size()) sim::die("wgmma operand outside shared memory", (long long)off);
  unsigned short v;
  std::memcpy(&v, sim::cur->smem.data() + off, 2);
  return __uint_as_float((unsigned)v << 16);
}

template <int N>
inline void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  const int wt = threadIdx.x % 128, w = wt / 32, lane = wt % 32, g = lane >> 2, t = lane & 3;
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * w + g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
      float s = 0.f;
      for (int k = 0; k < 16; ++k) s += operand(a, r, k) * operand(b, n, k);
      d[4 * j + e] = acc ? d[4 * j + e] + s : s;
    }
}

inline sim::Bar& bar_at(uint64_t* bar) {
  sim::check_smem(bar, 8);
  return sim::cur->bars[smem_addr(bar)];
}
inline void mbar_init(uint64_t* bar, unsigned count) {
  std::lock_guard<std::mutex> l(sim::cur->mu);
  sim::Bar& b = bar_at(bar);
  b.count = b.pending = (int)count;
  b.phase = 0;
}
inline void mbar_init_fence() {}
inline void complete_if_done(sim::Bar& b) {
  if (b.pending == 0 && b.tx == 0) {
    ++b.phase;
    b.pending = b.count;
    sim::cur->cv.notify_all();
  }
}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> l(sim::cur->mu);
  sim::Bar& b = bar_at(bar);
  if (b.count == 0) sim::die("arrive on an uninitialised mbarrier");
  if (b.pending == 0) sim::die("arrive on a barrier with no arrival pending");
  --b.pending;
  complete_if_done(b);
}
inline void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  std::lock_guard<std::mutex> l(sim::cur->mu);
  sim::Bar& b = bar_at(bar);
  b.tx += bytes;
  --b.pending;
  complete_if_done(b);
}
inline void complete_tx(uint64_t* bar, unsigned bytes) {
  std::lock_guard<std::mutex> l(sim::cur->mu);
  sim::Bar& b = bar_at(bar);
  b.tx -= bytes;
  if (b.tx < 0) sim::die("more bytes completed than expected");
  complete_if_done(b);
}
// TMA: synchronous copy of the box, zero outside the tensor
inline void tma_load_5d(void* dst, const void* tmap, int c0, int c1, int c2, int c3, int c4, uint64_t* bar) {
  const CUtensorMap& m = *static_cast<const CUtensorMap*>(tmap);
  const int c[5] = {c0, c1, c2, c3, c4};
  if ((size_t)smem_addr(dst) % 128) sim::die("TMA destination not 128-byte aligned", smem_addr(dst));
  unsigned char* d = static_cast<unsigned char*>(dst);
  size_t n = 0;
  for (uint32_t i4 = 0; i4 < m.box[4]; ++i4)
    for (uint32_t i3 = 0; i3 < m.box[3]; ++i3)
      for (uint32_t i2 = 0; i2 < m.box[2]; ++i2)
        for (uint32_t i1 = 0; i1 < m.box[1]; ++i1)
          for (uint32_t i0 = 0; i0 < m.box[0]; ++i0, n += 2) {
            const long long k[5] = {c[0] + (long long)i0, c[1] + (long long)i1, c[2] + (long long)i2,
                                    c[3] + (long long)i3, c[4] + (long long)i4};
            bool in = true;
            size_t off = 0;
            for (int r = 0; r < 5; ++r) {
              in = in && k[r] >= 0 && k[r] < (long long)m.dims[r];
              off += (size_t)k[r] * m.strides[r];
            }
            sim::check_smem(d + n, 2);
            if (in) {
              sim::check_global(m.base + off, 2);
              std::memcpy(d + n, m.base + off, 2);
            } else {
              std::memset(d + n, 0, 2);
            }
          }
  complete_tx(bar, (unsigned)n);
}
inline void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  if (bytes % 16 || (size_t)smem_addr(dst) % 16 || (uintptr_t)src % 16) sim::die("bulk copy misaligned");
  sim::check_smem(dst, bytes);
  sim::check_global(src, bytes);
  std::memcpy(dst, src, bytes);
  complete_tx(bar, bytes);
}
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  std::unique_lock<std::mutex> l(sim::cur->mu);
  sim::Bar& b = bar_at(bar);
  if (!sim::cur->cv.wait_for(l, std::chrono::seconds(300), [&] { return b.phase % 2 != parity; }))
    sim::die("mbarrier wait timed out (deadlock)", smem_addr(bar), parity);
}
inline void cp_async_arrive(uint64_t* bar) { mbar_arrive(bar); }
inline void named_barrier(unsigned id, unsigned count) {
  std::barrier<>* nb;
  {
    std::lock_guard<std::mutex> l(sim::cur->mu);
    auto& p = sim::cur->named[id];
    if (!p) p = std::make_unique<std::barrier<>>(count);
    nb = p.get();
  }
  nb->arrive_and_wait();
}
inline void fence_proxy_async() {}

}  // namespace ptx
}  // namespace ecm

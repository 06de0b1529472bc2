// CPU stand-in for the driver API pieces the pair kernel uses: a tensor map
// that records its base, extents, byte strides and box (read back by the TMA
// stub in wgmma.cuh), made by the encoder cudaGetDriverEntryPointByVersion
// hands out.
#pragma once
#include "cuda_runtime.h"
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUresult;
#define CUDA_SUCCESS 0
#define __grid_constant__
struct alignas(64) CUtensorMap {
  const unsigned char* base;
  int rank;
  uint64_t dims[5], strides[5];
  uint32_t box[5];
};
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_128B };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE };
typedef int cudaDriverEntryPointQueryResult;
enum { cudaDriverEntryPointSuccess = 0, cudaEnableDefault = 0 };
inline CUresult stub_encode(CUtensorMap* m, CUtensorMapDataType, cuuint32_t rank, void* base, const cuuint64_t* dims,
                            const cuuint64_t* strides, const cuuint32_t* box, const cuuint32_t* step,
                            CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  m->base = static_cast<const unsigned char*>(base);
  m->rank = (int)rank;
  m->strides[0] = 2;
  for (int i = 0; i < (int)rank; ++i) {
    m->dims[i] = dims[i];
    m->box[i] = box[i];
    if (step[i] != 1) return 1;
    if (i) m->strides[i] = strides[i - 1];
  }
  if ((uintptr_t)base % 16 || (box[0] * 2) % 16) return 1;
  for (int i = 1; i < (int)rank; ++i)
    if (m->strides[i] % 16) return 1;
  return 0;
}
inline cudaError_t cudaGetDriverEntryPointByVersion(const char*, void** fn, unsigned, unsigned long long,
                                                    cudaDriverEntryPointQueryResult* q) {
  *fn = reinterpret_cast<void*>(&stub_encode);
  *q = 0;
  return 0;
}

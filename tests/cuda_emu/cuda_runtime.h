// A stand-in for the CUDA runtime header that lets a kernel source compile as
// plain C++ and run on the host, one block and one thread at a time, so that
// AddressSanitizer and UBSan check every load and store of the kernel's body
// (tests/test_torch_soft_memcheck.py,
// tests/test_torch_bvh_memcheck.py).  Kernel launches are rewritten to
// emu_launch by the test.  A warp vote sees only the calling lane, so each
// lane adds its own vote: a kernel whose warp adds its lanes' votes adds the
// same total.  __syncthreads is empty: a block's shared memory is filled by
// its threads in turn, so the first launch over a shared table may read
// entries not yet staged (the test launches twice and keeps the second).
// Dynamic shared memory that a test reaches through emu_dynamic_shared (it
// rewrites the kernel's `extern __shared__ T name[];` to a call) is a heap
// buffer of exactly the launch's bytes, kept while the next launch asks for
// as many, so AddressSanitizer sees an access past the end.
#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
#define __restrict__

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline dim3 threadIdx, blockIdx, blockDim, gridDim;

struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return uint4{a, b, c, d};
}
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
template <class T>
T __ldg(const T* p) {
  return *p;
}
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, sizeof(i));
  return i;
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline unsigned emu_lane_bit() { return 1u << (threadIdx.x % 32); }
inline unsigned __ballot_sync(unsigned, bool pred) { return pred ? emu_lane_bit() : 0u; }
template <class T>
unsigned __match_any_sync(unsigned, T) {
  return emu_lane_bit();
}
inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p += v;
  return old;
}
inline void __syncthreads() {}

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

inline void* emu_smem = nullptr;
inline size_t emu_smem_bytes = 0;
template <class T>
T* emu_dynamic_shared() {
  return static_cast<T*>(emu_smem);
}

template <class F, class... A>
void emu_launch(unsigned grid, unsigned block, size_t smem, cudaStream_t, F kernel, A... args) {
  if (emu_smem == nullptr || smem != emu_smem_bytes) {
    ::operator delete(emu_smem, std::align_val_t(16));
    emu_smem = ::operator new(smem, std::align_val_t(16));
    emu_smem_bytes = smem;
  }
  gridDim.x = grid;
  blockDim.x = block;
  for (blockIdx.x = 0; blockIdx.x < grid; ++blockIdx.x)
    for (threadIdx.x = 0; threadIdx.x < block; ++threadIdx.x) kernel(args...);
}

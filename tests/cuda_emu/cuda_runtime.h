// A stand-in for the CUDA runtime header that lets a kernel source compile as
// plain C++ and run on the host, so that AddressSanitizer and UBSan check
// every load and store of the kernel's body (tests/test_torch_*_memcheck.py).
// The test rewrites kernel launches to emu_launch, which runs one block and
// one thread at a time, or to emu_launch_threads, which runs each block's
// threads at once on host threads, so that __syncthreads is a barrier and
// atomicAdd an atomic (a block's threads stage a shared table, add into it
// and flush it).  A warp vote sees only the calling lane, so each lane adds
// its own vote: a kernel whose warp adds its lanes' votes adds the same
// total.  The warp shuffles return the caller's own value: right only within
// a one-lane mask, which is all a vote returns here.  Under emu_launch,
// __syncthreads is empty: a block's shared memory is filled by its threads
// in turn, so the first launch over a shared table may read entries not yet
// staged (such a test launches twice and keeps the second).  Dynamic shared
// memory that a test reaches through emu_dynamic_shared (it rewrites the
// kernel's `extern __shared__ T name[];` to a call) is a heap buffer of
// exactly the launch's bytes, kept while the next launch asks for as many,
// so AddressSanitizer sees an access past the end.  The device queries of
// a launch (cudaDeviceGetAttribute, cudaOccupancy...) answer with emu_sms
// SMs of one block each, so a one-wave grid is small and strides.
#pragma once

#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

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
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;

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
template <class T>
T __shfl_sync(unsigned, T v, int) {
  return v;
}
// PTX fns.b32: the bit position of the offset-th set bit of mask from base.
inline unsigned __fns(unsigned mask, unsigned base, int offset) {
  if (offset == 0) return (mask >> base) & 1u ? base : 0xFFFFFFFFu;
  int count = (offset > 0 ? offset : -offset) - 1;
  for (int pos = static_cast<int>(base); pos >= 0 && pos < 32; pos += offset > 0 ? 1 : -1) {
    if ((mask >> pos) & 1u) {
      if (count == 0) return static_cast<unsigned>(pos);
      --count;
    }
  }
  return 0xFFFFFFFFu;
}
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline float atomicAdd(float* p, float v) {
  float old = *p, want;
  do {
    want = old + v;
  } while (!__atomic_compare_exchange(p, &old, &want, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST));
  return old;
}

// The barrier of a block whose threads run at once (emu_launch_threads).
struct EmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  unsigned n = 0, waiting = 0, generation = 0;
  void wait() {
    std::unique_lock<std::mutex> lock(m);
    const unsigned gen = generation;
    if (++waiting == n) {
      waiting = 0;
      ++generation;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return gen != generation; });
    }
  }
};
inline EmuBarrier* emu_barrier = nullptr;
inline void __syncthreads() {
  if (emu_barrier != nullptr) emu_barrier->wait();
}

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline int emu_sms = 2;
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = emu_sms;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}

inline void* emu_smem = nullptr;
inline size_t emu_smem_bytes = 0;
template <class T>
T* emu_dynamic_shared() {
  return static_cast<T*>(emu_smem);
}

inline void emu_shared(size_t smem) {
  if (emu_smem == nullptr || smem != emu_smem_bytes) {
    ::operator delete(emu_smem, std::align_val_t(16));
    emu_smem = ::operator new(smem, std::align_val_t(16));
    emu_smem_bytes = smem;
  }
}

template <class F, class... A>
void emu_launch(unsigned grid, unsigned block, size_t smem, cudaStream_t, F kernel, A... args) {
  emu_shared(smem);
  gridDim.x = grid;
  blockDim.x = block;
  for (blockIdx.x = 0; blockIdx.x < grid; ++blockIdx.x)
    for (threadIdx.x = 0; threadIdx.x < block; ++threadIdx.x) kernel(args...);
}

// One block at a time, its threads at once, __syncthreads a barrier.
template <class F, class... A>
void emu_launch_threads(unsigned grid, unsigned block, size_t smem, cudaStream_t, F kernel,
                        A... args) {
  emu_shared(smem);
  gridDim.x = grid;
  blockDim.x = block;
  EmuBarrier barrier;
  barrier.n = block;
  emu_barrier = &barrier;
  for (blockIdx.x = 0; blockIdx.x < grid; ++blockIdx.x) {
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block; ++t) {
      threads.emplace_back([=] {
        threadIdx.x = t;
        kernel(args...);
      });
    }
    for (auto& th : threads) th.join();
  }
  emu_barrier = nullptr;
}

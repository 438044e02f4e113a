// A stand-in for the CUDA runtime header that lets a kernel source compile as
// plain C++ and run on the host, so that AddressSanitizer and UBSan check
// every load and store of the kernel's body (tests/test_torch_*_memcheck.py).
// The test rewrites kernel launches to emu_launch, which runs one block and
// one thread at a time, or to emu_launch_threads, which runs each block's
// threads at once on host threads, so that __syncthreads is a barrier and
// atomicAdd an atomic (a block's threads stage a shared table, add into it
// and flush it).  cudaLaunchKernelEx runs a thread-block cluster: every
// thread of every block at once (the grid is the cluster), each block with
// shared memory of its own, cooperative_groups.h's cluster rank, mapping of
// another block's shared memory and cluster barrier, and cuda/atomic's
// atomic_ref (whose loads yield the host thread, so a spinning thread lets
// the others run).  A warp vote sees only the calling lane, so each lane adds
// its own vote: a kernel whose warp adds its lanes' votes adds the same
// total.  The warp shuffles return the caller's own value: right only within
// a one-lane mask, which is all a vote returns here, except the butterfly
// __shfl_xor_sync, which under emu_launch_threads and the cluster launch
// exchanges values between the lanes of a warp (its threads meet at a
// barrier), and __syncwarp is then the warp's barrier.  Under emu_launch,
// __syncthreads is empty: a block's shared memory is filled by its threads
// in turn, so the first launch over a shared table may read entries not yet
// staged (such a test launches twice and keeps the second).  Dynamic shared
// memory that a test reaches through emu_dynamic_shared (it rewrites the
// kernel's `extern __shared__ T name[];` to a call) is a heap buffer of
// exactly the launch's bytes, kept while the next launch asks for as many,
// so AddressSanitizer sees an access past the end.  The device queries of
// a launch (cudaDeviceGetAttribute, cudaOccupancy...) answer with emu_sms
// SMs of one block each, so a one-wave grid is small and strides;
// emu_max_grid caps any grid of emu_launch_threads the same way.
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
  dim3() = default;
  dim3(unsigned x_, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

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
template <class T>
T __ldcg(const T* p) {
  return *p;
}
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
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

// A block whose threads run at once: its barrier, its warps' barriers and
// shuffle slots (whole warps only) and its shared memory.
struct EmuBlock {
  EmuBarrier barrier;
  std::vector<EmuBarrier> warps;
  std::vector<float> slots;
  void* smem = nullptr;
  size_t smem_bytes = 0;
  void init(unsigned block) {
    barrier.n = block;
    warps = std::vector<EmuBarrier>(block % 32 == 0 ? block / 32 : 0);
    for (auto& w : warps) w.n = 32;
    slots.assign(block, 0.0f);
  }
};
inline thread_local EmuBlock* emu_block = nullptr;
inline void __syncthreads() {
  if (emu_block != nullptr) emu_block->barrier.wait();
}

// The butterfly shuffle of a warp whose 32 lanes run at once
// (emu_launch_threads with whole warps, or a cluster launch): each lane
// posts its value, the warp's lanes meet, each reads its partner's, and they
// meet again.  Every lane of the warp must call it, as on the card.  Under
// emu_launch (one thread at a time) it returns the caller's own value.
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  if (emu_block == nullptr || emu_block->warps.empty()) return v;
  const unsigned t = threadIdx.x, warp = t / 32;
  emu_block->slots[t] = v;
  emu_block->warps[warp].wait();
  const float other = emu_block->slots[warp * 32 + ((t % 32) ^ static_cast<unsigned>(lane_mask))];
  emu_block->warps[warp].wait();
  return other;
}
inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  if (emu_block != nullptr && !emu_block->warps.empty()) emu_block->warps[threadIdx.x / 32].wait();
}

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t err) {
  return err == cudaSuccess ? "no error" : "invalid argument";
}
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 11
};
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
  return static_cast<T*>(emu_block != nullptr && emu_block->smem != nullptr ? emu_block->smem
                                                                            : emu_smem);
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

// Caps emu_launch_threads's grid where not 0, so that a kernel whose blocks
// stride over their work runs its loop more than once.
inline unsigned emu_max_grid = 0;

// One block at a time, its threads at once, __syncthreads a barrier.
template <class F, class... A>
void emu_launch_threads(unsigned grid, unsigned block, size_t smem, cudaStream_t, F kernel,
                        A... args) {
  if (emu_max_grid != 0 && grid > emu_max_grid) grid = emu_max_grid;
  emu_shared(smem);
  gridDim.x = grid;
  blockDim.x = block;
  for (unsigned b = 0; b < grid; ++b) {
    EmuBlock ctx;
    ctx.init(block);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block; ++t) {
      threads.emplace_back([=, &ctx] {
        threadIdx.x = t;
        blockIdx.x = b;
        emu_block = &ctx;
        kernel(args...);
      });
    }
    for (auto& th : threads) th.join();
  }
}

// A thread-block cluster: the blocks of the grid, each with its own shared
// memory of exactly `smem` bytes, every thread at once.
inline std::vector<EmuBlock>* emu_cluster = nullptr;
inline EmuBarrier* emu_cluster_barrier = nullptr;

template <class F, class... A>
void emu_launch_cluster(unsigned grid, unsigned block, size_t smem, F kernel, A... args) {
  gridDim.x = grid;
  blockDim.x = block;
  std::vector<EmuBlock> blocks(grid);
  EmuBarrier barrier;
  barrier.n = grid * block;
  for (auto& b : blocks) {
    b.init(block);
    b.smem = ::operator new(smem, std::align_val_t(16));
    b.smem_bytes = smem;
  }
  emu_cluster = &blocks;
  emu_cluster_barrier = &barrier;
  std::vector<std::thread> threads;
  for (unsigned b = 0; b < grid; ++b) {
    for (unsigned t = 0; t < block; ++t) {
      threads.emplace_back([=, &blocks] {
        threadIdx.x = t;
        blockIdx.x = b;
        emu_block = &blocks[b];
        kernel(args...);
      });
    }
  }
  for (auto& th : threads) th.join();
  for (auto& b : blocks) ::operator delete(b.smem, std::align_val_t(16));
  emu_cluster = nullptr;
  emu_cluster_barrier = nullptr;
}

enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct {
    unsigned x, y, z;
  } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes = 0;
  cudaStream_t stream = nullptr;
  cudaLaunchAttribute* attrs = nullptr;
  unsigned numAttrs = 0;
};

// A launch whose cluster is the whole one-dimensional grid runs as one
// cluster; any other is refused.
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* config, void (*kernel)(P...),
                               A&&... args) {
  unsigned cluster = 1;
  for (unsigned i = 0; i < config->numAttrs; ++i)
    if (config->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cluster = config->attrs[i].val.clusterDim.x;
  if (cluster != config->gridDim.x || config->gridDim.y != 1 || config->gridDim.z != 1)
    return cudaErrorInvalidValue;
  emu_launch_cluster(config->gridDim.x, config->blockDim.x, config->dynamicSmemBytes, kernel,
                     static_cast<P>(args)...);
  return cudaSuccess;
}

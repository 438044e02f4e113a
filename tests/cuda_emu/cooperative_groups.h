// A stand-in for the thread-block cluster part of CUDA's cooperative_groups
// on the host (see cuda_runtime.h): under its cluster launch the cluster is
// the grid, a block's rank is its index, map_shared_rank moves a pointer into
// the calling block's shared memory to the same offset in another block's,
// and sync() is a barrier over every thread of the cluster.
#pragma once

#include <cassert>
#include <cstddef>

#include "cuda_runtime.h"

namespace cooperative_groups {

struct cluster_group {
  unsigned block_rank() const { return blockIdx.x; }
  template <class T>
  T* map_shared_rank(T* addr, unsigned rank) const {
    assert(emu_cluster != nullptr && rank < emu_cluster->size());
    const EmuBlock& own = (*emu_cluster)[blockIdx.x];
    const std::ptrdiff_t offset =
        reinterpret_cast<const char*>(addr) - static_cast<const char*>(own.smem);
    assert(offset >= 0 && static_cast<size_t>(offset) + sizeof(T) <= own.smem_bytes);
    return reinterpret_cast<T*>(static_cast<char*>((*emu_cluster)[rank].smem) + offset);
  }
  void sync() const {
    assert(emu_cluster_barrier != nullptr);
    emu_cluster_barrier->wait();
  }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups

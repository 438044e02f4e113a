// A stand-in for CUDA's <cuda_pipeline.h> on the host (see cuda_runtime.h):
// an asynchronous copy is a plain copy of size - zfill bytes followed by
// zfill zero bytes (no byte of the source is read when zfill == size), so
// the copies are complete when the calls return and a commit or wait has
// nothing left to do.
#pragma once

#include <cstddef>
#include <cstring>

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size, size_t zfill = 0) {
  if (size > zfill) std::memcpy(dst, src, size - zfill);
  std::memset(static_cast<char*>(dst) + (size - zfill), 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}

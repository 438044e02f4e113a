// A check of the soft-shadow sample stream, not part of the port: Philox4x32-10
// words from the CUDA toolkit's curand_Philox4x32_10 (curand_philox4x32_x.h),
// for comparing ops/soft.py's twin (and so soft.cu's generator) with the
// reference implementation.  Built on its own by chip_smoke.py
// (ops/_build.py load_check); nothing in the port calls it.
#include <curand_kernel.h>

namespace {

__global__ void philox_words(const uint4* __restrict__ ctr, const uint2* __restrict__ key,
                             int n, uint4* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = curand_Philox4x32_10(ctr[i], key[i]);
}

}  // namespace

extern "C" {

// out[i] = curand_Philox4x32_10(ctr[i], key[i]); ctr, out [n, 4] and key
// [n, 2] uint32.
int cgrt_check_philox(const unsigned* ctr, const unsigned* key, int n, unsigned* out,
                      cudaStream_t stream) {
  if (n > 0) {
    philox_words<<<(n + 127) / 128, 128, 0, stream>>>(reinterpret_cast<const uint4*>(ctr),
                                                     reinterpret_cast<const uint2*>(key), n,
                                                     reinterpret_cast<uint4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

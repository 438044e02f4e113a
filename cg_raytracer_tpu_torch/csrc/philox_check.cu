// Checks of the soft-shadow sample stream, not part of the port: Philox4x32-10
// words from the CUDA toolkit's curand_Philox4x32_10 (curand_philox4x32_x.h),
// for comparing ops/soft.py's twin (and so soft.cu's generator) with the
// reference implementation; and soft.cu's sincosf against sinf and cosf on
// every angle its Box-Muller takes.  Built on its own by chip_smoke.py
// (ops/_build.py load_check); nothing in the port calls it.
#include <curand_kernel.h>

namespace {

__global__ void philox_words(const uint4* __restrict__ ctr, const uint2* __restrict__ key,
                             int n, uint4* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = curand_Philox4x32_10(ctr[i], key[i]);
}

// Every 24-bit word b: x = 2 pi u01(b) as soft.cu's gauss3 forms it; counts
// the words whose sincosf(x) differs in any bit from (sinf(x), cosf(x)).
__global__ void sincos_mismatches(unsigned* __restrict__ bad) {
  const unsigned b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (1u << 24)) return;
  const float u = static_cast<float>(b) * (1.0f / 16777216.0f) + (0.5f / 16777216.0f);
  const float x = 6.283185307179586f * u;
  float s, c;
  sincosf(x, &s, &c);
  if (__float_as_uint(s) != __float_as_uint(sinf(x)) ||
      __float_as_uint(c) != __float_as_uint(cosf(x))) {
    atomicAdd(bad, 1u);
  }
}

}  // namespace

extern "C" {

// bad[0] += the number of mismatching words (sincos_mismatches).
int cgrt_check_sincos(unsigned* bad, cudaStream_t stream) {
  sincos_mismatches<<<(1u << 24) / 256, 256, 0, stream>>>(bad);
  return static_cast<int>(cudaGetLastError());
}

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

// Brute-force intersection oracles: closest hit, any hit, and the fused bounce.
//
// Replace three Pallas kernels of cg_raytracer_tpu/ops/pallas_kernels.py:
//   cgrt_closest <- _closest_kernel_entry (closest hit over a [T, 9] table),
//   cgrt_anyhit  <- _anyhit_kernel        (any hit with t < t_max),
//   cgrt_bounce  <- _bounce_kernel        (closest hit + per-light shadow bits).
// One templated sweep family over sweep.cuh's sweep: one thread per ray, the
// triangle table (three 16-byte rows per triangle) and the light positions
// staged in shared memory by each block of 128 rays, a run-time loop over
// T.  Rays come in as [N, 3] float32, results go out as [N] arrays; a ray
// with t_max < 0 is dead and exits at once (the Pallas kernels skipped whole
// dead tiles instead), and an any-hit ray stops at its first hit (the Pallas
// kernel checked a whole tile every 64 triangles).
//
// What bounds it on an H100: a ray-triangle test is 64 operations
// (utils/roofline.py) and a ray reads and writes about 40 bytes, so a
// closest sweep is bound by operations from T = 32 on; the bounce adds one
// any-hit sweep per light.  The sweep's instruction rate sets the pace
// (sweep.cuh): on the box at 1024^2 the closest kernel runs at 46% of its
// bound, the any-hit at 46%, the bounce at 38% (PERF.md, the brute
// sweeps).  The kernels allocate nothing, launch on the caller's stream and
// do not synchronise; each entry point returns cudaGetLastError().
#include <cstdint>

#include "sweep.cuh"

namespace cgrt {

enum class Mode { kClosest, kAnyHit, kBounce };

template <Mode M>
__global__ void __launch_bounds__(kThreads)
    oracle_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_max, int n, const float* __restrict__ tris,
                  int num_tris, const float* __restrict__ lights, int num_lights,
                  float* __restrict__ t_out, int* __restrict__ slot_out,
                  float* __restrict__ u_out, float* __restrict__ v_out,
                  int* __restrict__ bits_out, uint8_t* __restrict__ hit_out) {
  extern __shared__ float4 smem[];
  float* s_light = reinterpret_cast<float*>(smem + 3 * num_tris);
  stage_rows3(tris, num_tris, smem);
  if (M == Mode::kBounce) stage_rows(lights, 3 * num_lights, s_light);
  __syncthreads();

  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < n;
       j += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(j);
    const Ray r = load_ray(o, d, i);
    const float tm = t_max != nullptr ? t_max[i] : CUDART_INF_F;

    if (M == Mode::kAnyHit) {
      hit_out[i] = tm > 0.0f && any_hit_sweep(smem, num_tris, r, tm);
      continue;
    }

    float t_best = tm, u = 0.0f, v = 0.0f;
    int slot = -1;
    if (tm >= 0.0f) closest_sweep(smem, num_tris, r, t_best, slot, u, v);
    if (M == Mode::kBounce) {
      bits_out[i] = slot >= 0 ? shadow_bits(smem, num_tris, s_light, num_lights,
                                            r.ox + r.dx * t_best, r.oy + r.dy * t_best,
                                            r.oz + r.dz * t_best)
                              : 0;
    }
    t_out[i] = slot >= 0 ? t_best : CUDART_INF_F;
    slot_out[i] = slot;
    u_out[i] = u;
    v_out[i] = v;
  }
}

template <Mode M>
int launch(const float* o, const float* d, const float* t_max, int n, const float* tris,
           int num_tris, const float* lights, int num_lights, float* t, int* slot, float* u,
           float* v, int* bits, uint8_t* hit, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(float4) * 3 * num_tris + sizeof(float) * 3 * num_lights;
  oracle_kernel<M><<<num_blocks(n), kThreads, smem, stream>>>(
      o, d, t_max, n, tris, num_tris, lights, num_lights, t, slot, u, v, bits, hit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cgrt

extern "C" {

// t_max may be null (no bound).  Outputs: t (inf on a miss), slot (-1), u, v.
int cgrt_closest(const float* o, const float* d, const float* t_max, int n,
                 const float* tris, int num_tris, float* t, int* slot, float* u, float* v,
                 cudaStream_t stream) {
  return cgrt::launch<cgrt::Mode::kClosest>(o, d, t_max, n, tris, num_tris, nullptr, 0, t,
                                            slot, u, v, nullptr, nullptr, stream);
}

// hit[i] = 1 where some triangle lies at t in [0, t_max[i]).
int cgrt_anyhit(const float* o, const float* d, const float* t_max, int n,
                const float* tris, int num_tris, uint8_t* hit, cudaStream_t stream) {
  return cgrt::launch<cgrt::Mode::kAnyHit>(o, d, t_max, n, tris, num_tris, nullptr, 0,
                                           nullptr, nullptr, nullptr, nullptr, nullptr, hit,
                                           stream);
}

// Closest hit plus bit l of bits[i] set where light l (lights [L, 3]) is
// occluded from the hit point; t_max may be null, t_max < 0 marks a dead ray.
int cgrt_bounce(const float* o, const float* d, const float* t_max, int n,
                const float* tris, int num_tris, const float* lights, int num_lights,
                float* t, int* slot, float* u, float* v, int* bits, cudaStream_t stream) {
  return cgrt::launch<cgrt::Mode::kBounce>(o, d, t_max, n, tris, num_tris, lights,
                                           num_lights, t, slot, u, v, bits, nullptr, stream);
}

const char* cgrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Brute-force intersection oracles: closest hit, any hit, and the fused bounce.
//
// Replace three Pallas kernels of cg_raytracer_tpu/ops/pallas_kernels.py:
//   cgrt_closest <- _closest_kernel_entry (closest hit over a [T, 9] table),
//   cgrt_anyhit  <- _anyhit_kernel        (any hit with t < t_max),
//   cgrt_bounce  <- _bounce_kernel        (closest hit + per-light shadow bits).
// One templated sweep family: one thread per ray, the triangle table (and
// the light positions) staged in shared memory, a run-time loop over T.
// Rays come in as [N, 3] float32, results go out as [N] arrays; a ray with
// t_max < 0 is dead and exits at once (the Pallas kernels skipped whole dead
// tiles instead), and an any-hit ray stops at its first hit (the Pallas
// kernel checked a whole tile every 64 triangles).
//
// What bounds it on an H100: a ray-triangle test is about 30 FLOPs and a
// ray reads and writes about 40 bytes, so a closest sweep does ~0.75 * T
// FLOPs per byte, at or above the ridge (~20 FLOP/B) from T = 32 on; the
// bounce adds one any-hit sweep per light.  Measured, the sweep runs at
// ~11 TFLOP/s at T = 32 and at T = 256 alike, far from both roofs: the
// serial per-thread loop and one scalar shared-memory load per float bound
// it (PERF.md).  The kernels
// allocate nothing, launch on the caller's stream and do not synchronise;
// each entry point returns cudaGetLastError().
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
  extern __shared__ float smem[];
  float* s_tri = smem;
  float* s_light = smem + 9 * num_tris;
  stage_triangles(tris, num_tris, s_tri);
  if (M == Mode::kBounce) stage_rows(lights, 3 * num_lights, s_light);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i);
  const float tm = t_max != nullptr ? t_max[i] : CUDART_INF_F;

  if (M == Mode::kAnyHit) {
    hit_out[i] = tm > 0.0f && any_hit_sweep(s_tri, num_tris, r, tm);
    return;
  }

  float t_best = tm, u = 0.0f, v = 0.0f;
  int slot = -1;
  if (tm >= 0.0f) closest_sweep(s_tri, num_tris, r, t_best, slot, u, v);
  if (M == Mode::kBounce) {
    bits_out[i] = slot >= 0 ? shadow_bits(s_tri, num_tris, s_light, num_lights,
                                          r.ox + r.dx * t_best, r.oy + r.dy * t_best,
                                          r.oz + r.dz * t_best)
                            : 0;
  }
  t_out[i] = slot >= 0 ? t_best : CUDART_INF_F;
  slot_out[i] = slot;
  u_out[i] = u;
  v_out[i] = v;
}

template <Mode M>
int launch(const float* o, const float* d, const float* t_max, int n, const float* tris,
           int num_tris, const float* lights, int num_lights, float* t, int* slot, float* u,
           float* v, int* bits, uint8_t* hit, cudaStream_t stream) {
  if (n > 0) {
    const size_t smem = sizeof(float) * (9 * num_tris + 3 * num_lights);
    oracle_kernel<M><<<num_blocks(n), kThreads, smem, stream>>>(
        o, d, t_max, n, tris, num_tris, lights, num_lights, t, slot, u, v, bits, hit);
  }
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

// Two-phase records: every bounce level's closest hit, shadow bits and next
// ray, with no shading.  Phase 1 of the gradient structure (the two-phase
// branch of models/whitted.py::trace_rays); phase 2 shades the records.
//
// Replaces two Pallas kernels of cg_raytracer_tpu/ops/pallas_kernels.py:
//   cgrt_record_trace <- _record_trace_kernel (all levels in one launch),
//   cgrt_bounce_refl  <- _bounce_refl_kernel  (one level: the record loop's
//                        step when the whole-trace launch is not used).
// Both are the one body record_level: the closest sweep, the per-light
// shadow bits, then the attribute fetch, facing normal, reflection and
// continue-test that trace.cu runs (sweep.cuh::hit_surface, reflect_unit,
// continues), so the records' next rays are the trace kernel's rays.
//
// Design: one thread per ray carries its ray through max_depth levels in
// registers and writes, per level, t (inf on a miss), slot, u, v, bits, then
// for each level >= 1 the ray it starts from (o, d) and whether it is active.
// The triangle table (as v0, e1, e2), the attribute table [T, 19] and the
// light positions [L, 3] are staged in shared memory (<= 28.7 KB at T = 256).
// A dead ray (t_max < 0) writes the dead record (t = inf, slot -1, u = v = 0,
// bits 0, position and reflection 0, not reflective) without sweeping; a
// live ray that misses records its origin as the position and its unit
// direction as the reflection, as the Pallas kernel computes them.  Where
// the Pallas kernels skipped whole dead tiles, a dead ray here just exits.
//
// What bounds it on an H100: per level about (1 + L) * T Moller-Trumbore
// tests of ~30 FLOPs each (the sweeps of trace.cu) against (5 + 7) * 4
// bytes written per ray: compute- and issue-bound like the other sweeps,
// not memory-bound.  The records are written level-major, so the stores of
// a warp are coalesced.
#include <cstdint>

#include "sweep.cuh"

namespace cgrt {

struct Level {
  float t, u, v;
  int slot, bits;
  float px, py, pz, rx, ry, rz;
  bool reflective;
};

__device__ __forceinline__ Level record_level(const Ray& r, float tm, const float* s_tri,
                                              int num_tris, const float* s_aux,
                                              const float* s_light, int num_lights,
                                              int quirk_ks_z) {
  Level L{CUDART_INF_F, 0.0f, 0.0f, -1, 0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, false};
  if (tm < 0.0f) return L;  // dead ray: the dead record
  float t_best = tm;
  closest_sweep(s_tri, num_tris, r, t_best, L.slot, L.u, L.v);
  if (L.slot < 0) {
    // Miss: position o + d * 0, and the reflection about a zero normal.
    L.px = r.ox + r.dx * 0.0f;
    L.py = r.oy + r.dy * 0.0f;
    L.pz = r.oz + r.dz * 0.0f;
    reflect_unit(r, 0.0f, 0.0f, 0.0f, L.rx, L.ry, L.rz);
    return L;
  }
  L.t = t_best;
  const SurfaceAt s = hit_surface(r, t_best, L.slot, L.u, L.v, s_aux, num_tris, nullptr);
  L.px = s.px;
  L.py = s.py;
  L.pz = s.pz;
  L.bits = shadow_bits(s_tri, num_tris, s_light, num_lights, s.px, s.py, s.pz);
  reflect_unit(r, s.nx, s.ny, s.nz, L.rx, L.ry, L.rz);
  L.reflective = continues(s, quirk_ks_z);
  return L;
}

__device__ __forceinline__ void stage_record_tables(const float* tris, int num_tris,
                                                    const float* aux, const float* lights,
                                                    int num_lights, float* smem) {
  stage_triangles(tris, num_tris, smem);
  stage_rows(aux, 19 * num_tris, smem + 9 * num_tris);
  stage_rows(lights, 3 * num_lights, smem + 28 * num_tris);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    record_trace_kernel(const float* __restrict__ o, const float* __restrict__ d, int n,
                        const float* __restrict__ tris, int num_tris,
                        const float* __restrict__ aux, const float* __restrict__ lights,
                        int num_lights, int max_depth, int quirk_ks_z,
                        float* __restrict__ t_out, int* __restrict__ slot_out,
                        float* __restrict__ u_out, float* __restrict__ v_out,
                        int* __restrict__ bits_out, float* __restrict__ o_out,
                        float* __restrict__ d_out, uint8_t* __restrict__ active_out) {
  extern __shared__ float smem[];
  stage_record_tables(tris, num_tris, aux, lights, num_lights, smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(o, d, i);
  float tm = CUDART_INF_F;
  for (int level = 0; level < max_depth; ++level) {
    const Level L = record_level(r, tm, smem, num_tris, smem + 9 * num_tris,
                                 smem + 28 * num_tris, num_lights, quirk_ks_z);
    const size_t k = static_cast<size_t>(level) * n + i;
    t_out[k] = L.t;
    slot_out[k] = L.slot;
    u_out[k] = L.u;
    v_out[k] = L.v;
    bits_out[k] = L.bits;
    if (level + 1 >= max_depth) break;
    const bool active = L.reflective;  // false for dead and missed rays
    r = Ray{L.px + kReflectEps * L.rx, L.py + kReflectEps * L.ry, L.pz + kReflectEps * L.rz,
            active ? L.rx : r.dx, active ? L.ry : r.dy, active ? L.rz : r.dz};
    tm = active ? CUDART_INF_F : -1.0f;
    o_out[3 * k] = r.ox;
    o_out[3 * k + 1] = r.oy;
    o_out[3 * k + 2] = r.oz;
    d_out[3 * k] = r.dx;
    d_out[3 * k + 1] = r.dy;
    d_out[3 * k + 2] = r.dz;
    active_out[k] = active;
  }
}

__global__ void __launch_bounds__(kThreads)
    bounce_refl_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ t_max, int n, const float* __restrict__ tris,
                       int num_tris, const float* __restrict__ aux,
                       const float* __restrict__ lights, int num_lights, int quirk_ks_z,
                       float* __restrict__ t_out, int* __restrict__ slot_out,
                       float* __restrict__ u_out, float* __restrict__ v_out,
                       int* __restrict__ bits_out, float* __restrict__ pos_out,
                       float* __restrict__ refl_out, uint8_t* __restrict__ reflective_out) {
  extern __shared__ float smem[];
  stage_record_tables(tris, num_tris, aux, lights, num_lights, smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Level L = record_level(load_ray(o, d, i), t_max != nullptr ? t_max[i] : CUDART_INF_F,
                               smem, num_tris, smem + 9 * num_tris, smem + 28 * num_tris,
                               num_lights, quirk_ks_z);
  t_out[i] = L.t;
  slot_out[i] = L.slot;
  u_out[i] = L.u;
  v_out[i] = L.v;
  bits_out[i] = L.bits;
  pos_out[3 * i] = L.px;
  pos_out[3 * i + 1] = L.py;
  pos_out[3 * i + 2] = L.pz;
  refl_out[3 * i] = L.rx;
  refl_out[3 * i + 1] = L.ry;
  refl_out[3 * i + 2] = L.rz;
  reflective_out[i] = L.reflective;
}

size_t record_smem(int num_tris, int num_lights) {
  return sizeof(float) * (28 * num_tris + 3 * num_lights);
}

}  // namespace cgrt

extern "C" {

// Outputs per level l (level-major, [D, N]): t, slot, u, v, bits; per level
// l >= 1 the ray it starts from, o and d ([D - 1, N, 3]), and active.
int cgrt_record_trace(const float* o, const float* d, int n, const float* tris, int num_tris,
                      const float* aux, const float* lights, int num_lights, int max_depth,
                      int quirk_ks_z, float* t, int* slot, float* u, float* v, int* bits,
                      float* o_next, float* d_next, uint8_t* active, cudaStream_t stream) {
  if (n > 0) {
    cgrt::record_trace_kernel<<<cgrt::num_blocks(n), cgrt::kThreads,
                                cgrt::record_smem(num_tris, num_lights), stream>>>(
        o, d, n, tris, num_tris, aux, lights, num_lights, max_depth, quirk_ks_z, t, slot, u,
        v, bits, o_next, d_next, active);
  }
  return static_cast<int>(cudaGetLastError());
}

// One level: t, slot, u, v, bits [N], position and unit reflection [N, 3],
// reflective [N]; t_max may be null, t_max < 0 marks a dead ray.
int cgrt_bounce_refl(const float* o, const float* d, const float* t_max, int n,
                     const float* tris, int num_tris, const float* aux, const float* lights,
                     int num_lights, int quirk_ks_z, float* t, int* slot, float* u, float* v,
                     int* bits, float* position, float* refl, uint8_t* reflective,
                     cudaStream_t stream) {
  if (n > 0) {
    cgrt::bounce_refl_kernel<<<cgrt::num_blocks(n), cgrt::kThreads,
                               cgrt::record_smem(num_tris, num_lights), stream>>>(
        o, d, t_max, n, tris, num_tris, aux, lights, num_lights, quirk_ks_z, t, slot, u, v,
        bits, position, refl, reflective);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

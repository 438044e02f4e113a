// Forward-only Whitted trace: every bounce's closest hit, attribute fetch,
// Phong shading with hard shadows and the reflection step, in one kernel.
//
// Replaces cg_raytracer_tpu/ops/pallas_kernels.py::_trace_kernel (the
// forward-only megakernel behind `cgrt render`).  Rays stream in as [N, 3],
// colors stream out as [N, 3]; nothing else touches device memory.
//
// Design: one thread per ray carries its color, throughput and current ray
// through up to max_depth levels.  The triangle table [T, 9], the attribute
// table [T, 19] (n0 n1 n2, face normal, kd, ks, shininess), the sphere table
// [S, 11] (center, radius, kd, ks, shininess) and the lights [L, 6]
// (position, color) are staged in shared memory (at most ~29.6 KB at the
// caps T = 256, S = 16, L = 8).  Where the Pallas kernel selected attributes
// with one masked select per triangle (a TPU artefact), a thread here indexes
// the hit's row directly.  A ray that misses, or stops reflecting, exits;
// shadow sweeps stop at the first occluder.  The arithmetic follows
// trace_rays + reconstruct_hit + direct_point_lights op for op: the
// interpolated camera-facing normal, geometric sphere normals, the pow
// clamp, REFLECT_EPS / SHADOW_EPS = 1e-3 and the ks.z-only continue-test of
// the reference (main.cpp:246) under quirk_ks_z.
//
// What bounds it on an H100: per level a ray runs (1 + L) sweeps of ~30
// FLOPs per triangle against ~40 bytes of ray I/O in total, far above the
// ridge, so not device memory; measured, its sweeps share oracle.cu's
// limits (the serial loop and scalar shared-memory loads, PERF.md).
#include "sweep.cuh"

namespace cgrt {

__global__ void __launch_bounds__(kThreads)
    trace_kernel(const float* __restrict__ o, const float* __restrict__ d, int n,
                 const float* __restrict__ tris, int num_tris, const float* __restrict__ aux,
                 const float* __restrict__ spheres, int num_spheres,
                 const float* __restrict__ lights, int num_lights, int max_depth,
                 int quirk_ks_z, float* __restrict__ rgb) {
  extern __shared__ float smem[];
  float* s_tri = smem;
  float* s_aux = s_tri + 9 * num_tris;
  float* s_sph = s_aux + 19 * num_tris;
  float* s_light = s_sph + 11 * num_spheres;
  stage_triangles(tris, num_tris, s_tri);
  stage_rows(aux, 19 * num_tris, s_aux);
  stage_rows(spheres, 11 * num_spheres, s_sph);
  stage_rows(lights, 6 * num_lights, s_light);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(o, d, i);
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  float tpr = 1.0f, tpg = 1.0f, tpb = 1.0f;

  for (int level = 0; level < max_depth; ++level) {
    // Closest hit: triangles, then spheres (prim id T + s).
    float t_best = CUDART_INF_F, u = 0.0f, v = 0.0f;
    int slot = -1;
    closest_sweep(s_tri, num_tris, r, t_best, slot, u, v);
    const float a2 = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    for (int s = 0; s < num_spheres; ++s) {
      const float* row = s_sph + 11 * s;
      float t;
      if (sphere_hit(r, a2, row[0], row[1], row[2], row[3], t) && t < t_best) {
        t_best = t;
        slot = num_tris + s;
        u = 0.0f;
        v = 0.0f;
      }
    }
    if (slot < 0) break;  // miss: black from here on
    const SurfaceAt sf = hit_surface(r, t_best, slot, u, v, s_aux, num_tris, s_sph);
    const float px = sf.px, py = sf.py, pz = sf.pz, nx = sf.nx, ny = sf.ny, nz = sf.nz;
    const float kdx = sf.kdx, kdy = sf.kdy, kdz = sf.kdz, ksx = sf.ksx, ksy = sf.ksy,
                ksz = sf.ksz, shin = sf.shin;
    // Reflection of the view ray: the specular lobe and the next bounce.
    float rx, ry, rz;
    reflect_unit(r, nx, ny, nz, rx, ry, rz);

    for (int l = 0; l < num_lights; ++l) {
      const float* lrow = s_light + 6 * l;
      const float tox = lrow[0] - px, toy = lrow[1] - py, toz = lrow[2] - pz;
      const float dist = sqrtf(tox * tox + toy * toy + toz * toz);
      const float linv = 1.0f / fmaxf(dist, kNormEps);
      const float ldx = tox * linv, ldy = toy * linv, ldz = toz * linv;
      const Ray s{px + kShadowEps * ldx, py + kShadowEps * ldy, pz + kShadowEps * ldz,
                  ldx, ldy, ldz};
      const float tmax_l = dist - kShadowEps;
      bool blocked = any_hit_sweep(s_tri, num_tris, s, tmax_l);
      const float sa2 = ldx * ldx + ldy * ldy + ldz * ldz;
      for (int k = 0; k < num_spheres && !blocked; ++k) {
        const float* row = s_sph + 11 * k;
        float t2;
        blocked = sphere_hit(s, sa2, row[0], row[1], row[2], row[3], t2) && t2 < tmax_l;
      }
      if (blocked) continue;
      const float dcos = fmaxf(ldx * nx + ldy * ny + ldz * nz, 0.0f);
      const float scos = rx * ldx + ry * ldy + rz * ldz;
      const float spec = scos > 0.0f ? powf(fmaxf(scos, 1e-30f), shin) : 0.0f;
      cr = cr + tpr * lrow[3] * (kdx * dcos + ksx * spec);
      cg = cg + tpg * lrow[4] * (kdy * dcos + ksy * spec);
      cb = cb + tpb * lrow[5] * (kdz * dcos + ksz * spec);
    }

    if (level + 1 >= max_depth || !continues(sf, quirk_ks_z)) break;
    tpr = tpr * ksx;
    tpg = tpg * ksy;
    tpb = tpb * ksz;
    r = Ray{px + kReflectEps * rx, py + kReflectEps * ry, pz + kReflectEps * rz, rx, ry, rz};
  }
  rgb[3 * i] = cr;
  rgb[3 * i + 1] = cg;
  rgb[3 * i + 2] = cb;
}

}  // namespace cgrt

extern "C" int cgrt_trace(const float* o, const float* d, int n, const float* tris,
                          int num_tris, const float* aux, const float* spheres,
                          int num_spheres, const float* lights, int num_lights, int max_depth,
                          int quirk_ks_z, float* rgb, cudaStream_t stream) {
  if (n > 0) {
    const size_t smem =
        sizeof(float) * (28 * num_tris + 11 * num_spheres + 6 * num_lights);
    cgrt::trace_kernel<<<cgrt::num_blocks(n), cgrt::kThreads, smem, stream>>>(
        o, d, n, tris, num_tris, aux, spheres, num_spheres, lights, num_lights, max_depth,
        quirk_ks_z, rgb);
  }
  return static_cast<int>(cudaGetLastError());
}

// Fused differentiable shade: reconstruct + point-light Phong at recorded
// hits, forward and backward.  Phase 2 of the two-phase gradient structure
// (models/whitted.py::trace_rays), behind ops/shade.py::_ShadeFn.
//
// Replaces two Pallas kernels of cg_raytracer_tpu/ops/pallas_shade.py:
//   cgrt_shade_fwd <- _shade_fwd_kernel (#23, the select-gather forward),
//   cgrt_shade_bwd <- _shade_bwd_kernel (#25, its VJP).
// The math is _shade_math (pallas_shade.py:128-261) op for op, and its
// plain PyTorch twin is ops/shade.py::shade_plain.  Where the Pallas kernels
// selected the hit's row with one masked select per triangle (so T <= 64
// there, and a pregathered [N, 19] payload beyond), a thread here indexes
// the row in shared memory: one kernel covers T <= 256.
//
// Inputs: rays o, d [N, 3]; the recorded prim id and shadow bits [N] (int32,
// discrete); tables tri [T, 9] (v0 v1 v2), aux [T, 19] (n0 n1 n2, face
// normal, kd, ks, shininess), lights [L, 6] (position, color), spheres
// [S, 11] (center, radius, kd, ks, shininess).  A ray is live where
// 0 <= prim < T + S: prim < T is a triangle, T + s sphere s; any other prim
// is a miss, whose outputs and cotangents are exactly 0 (the Pallas kernel
// let misses fall through to row 0 and gated them; here they do no work).
//
// Forward (one thread per ray; tables staged in shared memory, <= 29.4 KB at
// T = 256, L = 16, S = 8): Moller-Trumbore recompute on the hit triangle
// (det_safe), the interpolated normal flipped toward the viewer, or the
// sphere quadratic recompute and geometric normal; the unit reflection of
// d; then per light not blocked by its bit, diffuse max(ld.n, 0) and
// specular pow(max(r.ld, 1e-30), shininess) where r.ld > 0.  Outputs
// direct, ks, normal, position, each [N, 3].
//
// Backward: the same forward recomputed in registers, then the reverse pass
// written out by hand (the Pallas kernel traced jax.vjp inside its body).
// The derivation is csrc/SHADE_BWD.md.  Per-ray cotangents d_o, d_d [N, 3]
// are stored; table cotangents are summed per block into a shared-memory
// copy of the tables with atomicAdd, then added once per block to d_tri,
// d_aux, d_lights, d_spheres in device memory with atomicAdd (the wrapper
// zeroes them).  The grid is one wave of blocks that stride over the rays,
// so each block flushes once.  fp32 atomics sum in an order that changes from
// run to run: the table gradients are not bitwise reproducible (they vary in
// the last bits), and the on-card checks compare them to their twin with a
// tolerance that covers float32 summation (utils/checks.py).
//
// What bounds it on an H100: the forward is ~100 FLOPs per ray and light
// against 56 bytes of ray I/O in and 48 out, so neither roof at these sizes:
// latency of the branchy per-thread program.  The backward adds ~3x the
// FLOPs and, per live ray, 28 + 6 L shared-memory atomics.  Coherent rays
// that hit one wall all add into the same table row, so those atomics
// serialise: that contention is its expected bound (PERF.md measures it).
#include <cstdint>

#include "sweep.cuh"

namespace cgrt {

constexpr float kSpecEps = 1e-30f;

// d max(a, b) / da, with a tie split in half (jnp.maximum, torch.maximum).
__device__ __forceinline__ float max_weight(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

struct Tables {
  const float* tri;    // [rows, 9]
  const float* aux;    // [rows, 19]
  const float* light;  // [L, 6]
  const float* sph;    // [S, 11]
  int num_tris, num_lights, num_spheres;
};

__device__ __forceinline__ Tables stage_shade_tables(const float* tris, const float* aux,
                                                     int rows, const float* lights,
                                                     int num_lights, const float* spheres,
                                                     int num_spheres, int num_tris,
                                                     float* smem) {
  Tables tb{smem, smem + 9 * rows, smem + 28 * rows, smem + 28 * rows + 6 * num_lights,
            num_tris, num_lights, num_spheres};
  stage_rows(tris, 9 * rows, smem);
  stage_rows(aux, 19 * rows, smem + 9 * rows);
  stage_rows(lights, 6 * num_lights, smem + 28 * rows);
  stage_rows(spheres, 11 * num_spheres, smem + 28 * rows + 6 * num_lights);
  return tb;
}

// Forward of one live ray, with what the reverse pass reads.
struct Fwd {
  bool sphere;
  int row;
  // Moller-Trumbore on the hit triangle.
  float e1x, e1y, e1z, e2x, e2y, e2z, pvx, pvy, pvz, tvx, tvy, tvz, qvx, qvy, qvz;
  float inv_det, U, V, Tn, t, u, v, w0;
  bool ok_det;
  // Interpolated normal before normalisation, its norm and reciprocal; flip.
  float ntx, nty, ntz, ns, ninv, flip;
  // Sphere quadratic.
  float ocx, ocy, ocz, qa, qb, sq, inv2a, t_sp, sntx, snty, sntz, ss, sinv;
  bool disc_ok, small, t_ok;
  // Surface.
  float px, py, pz, nx, ny, nz, kdx, kdy, kdz, ksx, ksy, ksz, shin;
  // Reflection before normalisation, its norm and reciprocal; unit reflection.
  float ddn, rtx, rty, rtz, rs, rinv, rx, ry, rz;
};

__device__ __forceinline__ void shade_surface(const Tables& tb, const Ray& r, int slot,
                                              Fwd& f) {
  f.sphere = slot >= tb.num_tris;
  if (!f.sphere) {
    f.row = slot;
    const float* tri = tb.tri + 9 * slot;
    const float* a = tb.aux + 19 * slot;
    const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
    f.e1x = tri[3] - v0x, f.e1y = tri[4] - v0y, f.e1z = tri[5] - v0z;
    f.e2x = tri[6] - v0x, f.e2y = tri[7] - v0y, f.e2z = tri[8] - v0z;
    f.pvx = r.dy * f.e2z - r.dz * f.e2y;
    f.pvy = r.dz * f.e2x - r.dx * f.e2z;
    f.pvz = r.dx * f.e2y - r.dy * f.e2x;
    const float det = f.e1x * f.pvx + f.e1y * f.pvy + f.e1z * f.pvz;
    f.ok_det = fabsf(det) > kMtEps;
    f.inv_det = f.ok_det ? 1.0f / det : 0.0f;
    f.tvx = r.ox - v0x, f.tvy = r.oy - v0y, f.tvz = r.oz - v0z;
    f.U = f.tvx * f.pvx + f.tvy * f.pvy + f.tvz * f.pvz;
    f.u = f.U * f.inv_det;
    f.qvx = f.tvy * f.e1z - f.tvz * f.e1y;
    f.qvy = f.tvz * f.e1x - f.tvx * f.e1z;
    f.qvz = f.tvx * f.e1y - f.tvy * f.e1x;
    f.V = r.dx * f.qvx + r.dy * f.qvy + r.dz * f.qvz;
    f.v = f.V * f.inv_det;
    f.Tn = f.e2x * f.qvx + f.e2y * f.qvy + f.e2z * f.qvz;
    f.t = f.Tn * f.inv_det;
    f.px = r.ox + r.dx * f.t;
    f.py = r.oy + r.dy * f.t;
    f.pz = r.oz + r.dz * f.t;
    f.w0 = 1.0f - f.u - f.v;
    f.ntx = f.w0 * a[0] + f.u * a[3] + f.v * a[6];
    f.nty = f.w0 * a[1] + f.u * a[4] + f.v * a[7];
    f.ntz = f.w0 * a[2] + f.u * a[5] + f.v * a[8];
    f.ns = sqrtf(f.ntx * f.ntx + f.nty * f.nty + f.ntz * f.ntz);
    f.ninv = 1.0f / fmaxf(f.ns, kNormEps);
    f.flip = (a[9] * r.dx + a[10] * r.dy + a[11] * r.dz) < 0.0f ? 1.0f : -1.0f;
    f.nx = f.ntx * f.ninv * f.flip;
    f.ny = f.nty * f.ninv * f.flip;
    f.nz = f.ntz * f.ninv * f.flip;
    f.kdx = a[12], f.kdy = a[13], f.kdz = a[14];
    f.ksx = a[15], f.ksy = a[16], f.ksz = a[17];
    f.shin = a[18];
  } else {
    f.row = slot - tb.num_tris;
    const float* s = tb.sph + 11 * f.row;
    f.ocx = r.ox - s[0], f.ocy = r.oy - s[1], f.ocz = r.oz - s[2];
    f.qa = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    f.qb = 2.0f * (r.dx * f.ocx + r.dy * f.ocy + r.dz * f.ocz);
    const float qc = f.ocx * f.ocx + f.ocy * f.ocy + f.ocz * f.ocz - s[3] * s[3];
    const float disc = f.qb * f.qb - 4.0f * f.qa * qc;
    f.disc_ok = disc > 0.0f;
    f.sq = f.disc_ok ? sqrtf(disc) : 0.0f;
    f.inv2a = 1.0f / (2.0f * f.qa);
    const float t_small = (-f.qb - f.sq) * f.inv2a;
    const float t_big = (-f.qb + f.sq) * f.inv2a;
    f.small = t_small >= 0.0f;
    const float t_sel = f.small ? t_small : t_big;
    f.t_ok = f.disc_ok && t_sel >= 0.0f;
    f.t_sp = f.t_ok ? t_sel : 0.0f;
    f.px = r.ox + r.dx * f.t_sp;
    f.py = r.oy + r.dy * f.t_sp;
    f.pz = r.oz + r.dz * f.t_sp;
    f.sntx = f.px - s[0], f.snty = f.py - s[1], f.sntz = f.pz - s[2];
    f.ss = sqrtf(f.sntx * f.sntx + f.snty * f.snty + f.sntz * f.sntz);
    f.sinv = 1.0f / fmaxf(f.ss, kNormEps);
    f.nx = f.sntx * f.sinv, f.ny = f.snty * f.sinv, f.nz = f.sntz * f.sinv;
    f.kdx = s[4], f.kdy = s[5], f.kdz = s[6];
    f.ksx = s[7], f.ksy = s[8], f.ksz = s[9];
    f.shin = s[10];
  }
  f.ddn = r.dx * f.nx + r.dy * f.ny + r.dz * f.nz;
  f.rtx = r.dx - 2.0f * f.ddn * f.nx;
  f.rty = r.dy - 2.0f * f.ddn * f.ny;
  f.rtz = r.dz - 2.0f * f.ddn * f.nz;
  f.rs = sqrtf(f.rtx * f.rtx + f.rty * f.rty + f.rtz * f.rtz);
  f.rinv = 1.0f / fmaxf(f.rs, kNormEps);
  f.rx = f.rtx * f.rinv, f.ry = f.rty * f.rinv, f.rz = f.rtz * f.rinv;
}

// One light's geometry and Phong terms at the surface.
struct LightTerms {
  float tox, toy, toz, ls, linv, ldx, ldy, ldz, x, dcos, scos, b, spec;
};

__device__ __forceinline__ LightTerms light_terms(const Fwd& f, const float* lrow) {
  LightTerms L;
  L.tox = lrow[0] - f.px, L.toy = lrow[1] - f.py, L.toz = lrow[2] - f.pz;
  L.ls = sqrtf(L.tox * L.tox + L.toy * L.toy + L.toz * L.toz);
  L.linv = 1.0f / fmaxf(L.ls, kNormEps);
  L.ldx = L.tox * L.linv, L.ldy = L.toy * L.linv, L.ldz = L.toz * L.linv;
  L.x = L.ldx * f.nx + L.ldy * f.ny + L.ldz * f.nz;
  L.dcos = fmaxf(L.x, 0.0f);
  L.scos = f.rx * L.ldx + f.ry * L.ldy + f.rz * L.ldz;
  L.b = fmaxf(L.scos, kSpecEps);
  L.spec = L.scos > 0.0f ? powf(L.b, f.shin) : 0.0f;
  return L;
}

__device__ __forceinline__ bool live_slot(int slot, const Tables& tb) {
  return slot >= 0 && slot < tb.num_tris + tb.num_spheres;
}

__global__ void __launch_bounds__(kThreads)
    shade_fwd_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const int* __restrict__ prim, const int* __restrict__ bits_in, int n,
                     const float* __restrict__ tris, const float* __restrict__ aux, int rows,
                     int num_tris, const float* __restrict__ lights, int num_lights,
                     const float* __restrict__ spheres, int num_spheres,
                     float* __restrict__ direct, float* __restrict__ ks_out,
                     float* __restrict__ normal, float* __restrict__ position) {
  extern __shared__ float smem[];
  const Tables tb = stage_shade_tables(tris, aux, rows, lights, num_lights, spheres,
                                       num_spheres, num_tris, smem);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int slot = prim[i];
  float out[12] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (live_slot(slot, tb)) {
    const Ray r = load_ray(o, d, i);
    Fwd f;
    shade_surface(tb, r, slot, f);
    const int bits = bits_in[i];
    for (int l = 0; l < tb.num_lights; ++l) {
      if ((bits >> l) & 1) continue;
      const float* lrow = tb.light + 6 * l;
      const LightTerms L = light_terms(f, lrow);
      out[0] = out[0] + lrow[3] * (f.kdx * L.dcos + f.ksx * L.spec);
      out[1] = out[1] + lrow[4] * (f.kdy * L.dcos + f.ksy * L.spec);
      out[2] = out[2] + lrow[5] * (f.kdz * L.dcos + f.ksz * L.spec);
    }
    out[3] = f.ksx, out[4] = f.ksy, out[5] = f.ksz;
    out[6] = f.nx, out[7] = f.ny, out[8] = f.nz;
    out[9] = f.px, out[10] = f.py, out[11] = f.pz;
  }
  for (int c = 0; c < 3; ++c) {
    direct[3 * i + c] = out[c];
    ks_out[3 * i + c] = out[3 + c];
    normal[3 * i + c] = out[6 + c];
    position[3 * i + c] = out[9 + c];
  }
}

// Reverse of y = x * inv, inv = 1 / max(s, eps), s = |x|: adds dy's pull-back to gx.
__device__ __forceinline__ void normalize_bwd(float x0, float x1, float x2, float s, float inv,
                                              float gy0, float gy1, float gy2, float& gx0,
                                              float& gx1, float& gx2) {
  gx0 += gy0 * inv;
  gx1 += gy1 * inv;
  gx2 += gy2 * inv;
  const float g_inv = gy0 * x0 + gy1 * x1 + gy2 * x2;
  const float g_s = -g_inv * inv * inv * max_weight(s, kNormEps);
  if (g_s != 0.0f) {
    const float k = g_s / s;  // d s / d x = x / s
    gx0 += k * x0;
    gx1 += k * x1;
    gx2 += k * x2;
  }
}

__global__ void __launch_bounds__(kThreads)
    shade_bwd_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const int* __restrict__ prim, const int* __restrict__ bits_in, int n,
                     const float* __restrict__ tris, const float* __restrict__ aux, int rows,
                     int num_tris, const float* __restrict__ lights, int num_lights,
                     const float* __restrict__ spheres, int num_spheres,
                     const float* __restrict__ g_direct, const float* __restrict__ g_ks,
                     const float* __restrict__ g_normal, const float* __restrict__ g_position,
                     float* __restrict__ d_o, float* __restrict__ d_d,
                     float* __restrict__ d_tri, float* __restrict__ d_aux,
                     float* __restrict__ d_lights, float* __restrict__ d_spheres) {
  extern __shared__ float smem[];
  const int table_floats = 28 * rows + 6 * num_lights + 11 * num_spheres;
  const Tables tb = stage_shade_tables(tris, aux, rows, lights, num_lights, spheres,
                                       num_spheres, num_tris, smem);
  // Gradient accumulators: the same layout, right after the tables.
  float* acc = smem + table_floats;
  float* a_tri = acc;
  float* a_aux = acc + 9 * rows;
  float* a_light = acc + 28 * rows;
  float* a_sph = acc + 28 * rows + 6 * num_lights;
  for (int k = threadIdx.x; k < table_floats; k += blockDim.x) acc[k] = 0.0f;
  __syncthreads();

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int slot = prim[i];
    float go[3] = {0.0f, 0.0f, 0.0f}, gd[3] = {0.0f, 0.0f, 0.0f};
    if (live_slot(slot, tb)) {
      const Ray r = load_ray(o, d, i);
      Fwd f;
      shade_surface(tb, r, slot, f);
      const int bits = bits_in[i];
      const float gD[3] = {g_direct[3 * i], g_direct[3 * i + 1], g_direct[3 * i + 2]};
      // Cotangents of the surface: position and normal, kd, ks, shininess,
      // and of the unit reflection.
      float gpx = g_position[3 * i], gpy = g_position[3 * i + 1], gpz = g_position[3 * i + 2];
      float gnx = g_normal[3 * i], gny = g_normal[3 * i + 1], gnz = g_normal[3 * i + 2];
      float gkd[3] = {0.0f, 0.0f, 0.0f};
      float gks[3] = {g_ks[3 * i], g_ks[3 * i + 1], g_ks[3 * i + 2]};
      float gshin = 0.0f, grx = 0.0f, gry = 0.0f, grz = 0.0f;

      // Lights (SHADE_BWD.md, "Lights").
      const float kd[3] = {f.kdx, f.kdy, f.kdz}, ks[3] = {f.ksx, f.ksy, f.ksz};
      for (int l = 0; l < tb.num_lights; ++l) {
        if ((bits >> l) & 1) continue;
        const float* lrow = tb.light + 6 * l;
        const LightTerms L = light_terms(f, lrow);
        float g_dcos = 0.0f, g_spec = 0.0f;
        for (int c = 0; c < 3; ++c) {
          const float gA = gD[c] * lrow[3 + c];
          atomicAdd(&a_light[6 * l + 3 + c], gD[c] * (kd[c] * L.dcos + ks[c] * L.spec));
          gkd[c] += gA * L.dcos;
          gks[c] += gA * L.spec;
          g_dcos += gA * kd[c];
          g_spec += gA * ks[c];
        }
        float g_scos = 0.0f;
        if (L.scos > 0.0f) {
          gshin += g_spec * L.spec * logf(L.b);
          g_scos = g_spec * f.shin * powf(L.b, f.shin - 1.0f) * max_weight(L.scos, kSpecEps);
        }
        const float g_x = g_dcos * max_weight(L.x, 0.0f);
        // scos = r . ld, x = ld . n
        grx += g_scos * L.ldx, gry += g_scos * L.ldy, grz += g_scos * L.ldz;
        const float gldx = g_scos * f.rx + g_x * f.nx;
        const float gldy = g_scos * f.ry + g_x * f.ny;
        const float gldz = g_scos * f.rz + g_x * f.nz;
        gnx += g_x * L.ldx, gny += g_x * L.ldy, gnz += g_x * L.ldz;
        // ld = normalize(to), to = light - p
        float gtx = 0.0f, gty = 0.0f, gtz = 0.0f;
        normalize_bwd(L.tox, L.toy, L.toz, L.ls, L.linv, gldx, gldy, gldz, gtx, gty, gtz);
        atomicAdd(&a_light[6 * l], gtx);
        atomicAdd(&a_light[6 * l + 1], gty);
        atomicAdd(&a_light[6 * l + 2], gtz);
        gpx -= gtx, gpy -= gty, gpz -= gtz;
      }

      // Reflection: r = normalize(rt), rt = d - 2 (d . n) n (SHADE_BWD.md, "Reflection").
      float grtx = 0.0f, grty = 0.0f, grtz = 0.0f;
      normalize_bwd(f.rtx, f.rty, f.rtz, f.rs, f.rinv, grx, gry, grz, grtx, grty, grtz);
      gd[0] += grtx, gd[1] += grty, gd[2] += grtz;
      const float g_ddn = -2.0f * (grtx * f.nx + grty * f.ny + grtz * f.nz);
      const float m = -2.0f * f.ddn;
      gnx += m * grtx + g_ddn * r.dx;
      gny += m * grty + g_ddn * r.dy;
      gnz += m * grtz + g_ddn * r.dz;
      gd[0] += g_ddn * f.nx, gd[1] += g_ddn * f.ny, gd[2] += g_ddn * f.nz;

      if (f.sphere) {
        // Sphere (SHADE_BWD.md, "Sphere").
        float* as = a_sph + 11 * f.row;
        const float* s = tb.sph + 11 * f.row;
        float gsx = gpx, gsy = gpy, gsz = gpz;  // cotangent of the point sp
        float gcx = 0.0f, gcy = 0.0f, gcz = 0.0f;
        float gsnx = 0.0f, gsny = 0.0f, gsnz = 0.0f;
        normalize_bwd(f.sntx, f.snty, f.sntz, f.ss, f.sinv, gnx, gny, gnz, gsnx, gsny, gsnz);
        gsx += gsnx, gsy += gsny, gsz += gsnz;
        gcx -= gsnx, gcy -= gsny, gcz -= gsnz;
        go[0] += gsx, go[1] += gsy, go[2] += gsz;
        gd[0] += gsx * f.t_sp, gd[1] += gsy * f.t_sp, gd[2] += gsz * f.t_sp;
        float grad = 0.0f;
        if (f.t_ok) {
          const float g_t = gsx * r.dx + gsy * r.dy + gsz * r.dz;
          const float sgn = f.small ? -1.0f : 1.0f;  // t = (-qb -/+ sq) * inv2a
          float g_qb = -g_t * f.inv2a;
          const float g_sq = sgn * g_t * f.inv2a;
          const float g_inv2a = g_t * (-f.qb + sgn * f.sq);
          float g_qa = -2.0f * g_inv2a * f.inv2a * f.inv2a;
          const float rad = s[3];
          const float g_disc = g_sq * 0.5f / f.sq;
          g_qb += 2.0f * f.qb * g_disc;
          const float qc = f.ocx * f.ocx + f.ocy * f.ocy + f.ocz * f.ocz - rad * rad;
          g_qa += -4.0f * qc * g_disc;
          const float g_qc = -4.0f * f.qa * g_disc;
          // qa = d.d, qb = 2 d.oc, qc = oc.oc - rad^2, oc = o - c
          gd[0] += 2.0f * g_qa * r.dx + 2.0f * g_qb * f.ocx;
          gd[1] += 2.0f * g_qa * r.dy + 2.0f * g_qb * f.ocy;
          gd[2] += 2.0f * g_qa * r.dz + 2.0f * g_qb * f.ocz;
          const float gocx = 2.0f * g_qb * r.dx + 2.0f * g_qc * f.ocx;
          const float gocy = 2.0f * g_qb * r.dy + 2.0f * g_qc * f.ocy;
          const float gocz = 2.0f * g_qb * r.dz + 2.0f * g_qc * f.ocz;
          go[0] += gocx, go[1] += gocy, go[2] += gocz;
          gcx -= gocx, gcy -= gocy, gcz -= gocz;
          grad = -2.0f * rad * g_qc;
        }
        atomicAdd(&as[0], gcx);
        atomicAdd(&as[1], gcy);
        atomicAdd(&as[2], gcz);
        atomicAdd(&as[3], grad);
        for (int c = 0; c < 3; ++c) {
          atomicAdd(&as[4 + c], gkd[c]);
          atomicAdd(&as[7 + c], gks[c]);
        }
        atomicAdd(&as[10], gshin);
      } else {
        // Triangle (SHADE_BWD.md, "Normal" and "Moller-Trumbore").
        float* at = a_tri + 9 * f.row;
        float* aa = a_aux + 19 * f.row;
        const float* a = tb.aux + 19 * f.row;
        float gntx = 0.0f, gnty = 0.0f, gntz = 0.0f;
        normalize_bwd(f.ntx, f.nty, f.ntz, f.ns, f.ninv, gnx * f.flip, gny * f.flip,
                      gnz * f.flip, gntx, gnty, gntz);
        const float g_w0 = gntx * a[0] + gnty * a[1] + gntz * a[2];
        const float g_u = gntx * a[3] + gnty * a[4] + gntz * a[5] - g_w0;
        const float g_v = gntx * a[6] + gnty * a[7] + gntz * a[8] - g_w0;
        atomicAdd(&aa[0], f.w0 * gntx);
        atomicAdd(&aa[1], f.w0 * gnty);
        atomicAdd(&aa[2], f.w0 * gntz);
        atomicAdd(&aa[3], f.u * gntx);
        atomicAdd(&aa[4], f.u * gnty);
        atomicAdd(&aa[5], f.u * gntz);
        atomicAdd(&aa[6], f.v * gntx);
        atomicAdd(&aa[7], f.v * gnty);
        atomicAdd(&aa[8], f.v * gntz);
        for (int c = 0; c < 3; ++c) {
          atomicAdd(&aa[12 + c], gkd[c]);
          atomicAdd(&aa[15 + c], gks[c]);
        }
        atomicAdd(&aa[18], gshin);
        // p = o + d t
        go[0] += gpx, go[1] += gpy, go[2] += gpz;
        gd[0] += gpx * f.t, gd[1] += gpy * f.t, gd[2] += gpz * f.t;
        const float g_t = gpx * r.dx + gpy * r.dy + gpz * r.dz;
        // u = U inv_det, v = V inv_det, t = Tn inv_det
        const float g_inv = g_u * f.U + g_v * f.V + g_t * f.Tn;
        const float gU = g_u * f.inv_det, gV = g_v * f.inv_det, gT = g_t * f.inv_det;
        // U = tv . pv, V = d . qv, Tn = e2 . qv
        float gtvx = gU * f.pvx, gtvy = gU * f.pvy, gtvz = gU * f.pvz;
        float gpvx = gU * f.tvx, gpvy = gU * f.tvy, gpvz = gU * f.tvz;
        gd[0] += gV * f.qvx, gd[1] += gV * f.qvy, gd[2] += gV * f.qvz;
        const float gqx = gV * r.dx + gT * f.e2x;
        const float gqy = gV * r.dy + gT * f.e2y;
        const float gqz = gV * r.dz + gT * f.e2z;
        float ge2x = gT * f.qvx, ge2y = gT * f.qvy, ge2z = gT * f.qvz;
        // qv = tv x e1: g_tv += e1 x g_qv, g_e1 = g_qv x tv
        gtvx += f.e1y * gqz - f.e1z * gqy;
        gtvy += f.e1z * gqx - f.e1x * gqz;
        gtvz += f.e1x * gqy - f.e1y * gqx;
        float ge1x = gqy * f.tvz - gqz * f.tvy;
        float ge1y = gqz * f.tvx - gqx * f.tvz;
        float ge1z = gqx * f.tvy - gqy * f.tvx;
        // tv = o - v0
        go[0] += gtvx, go[1] += gtvy, go[2] += gtvz;
        // inv_det = 1 / det where |det| > eps (det_safe), det = e1 . pv
        const float g_det = f.ok_det ? -g_inv * f.inv_det * f.inv_det : 0.0f;
        ge1x += g_det * f.pvx, ge1y += g_det * f.pvy, ge1z += g_det * f.pvz;
        gpvx += g_det * f.e1x, gpvy += g_det * f.e1y, gpvz += g_det * f.e1z;
        // pv = d x e2: g_d += e2 x g_pv, g_e2 += g_pv x d
        gd[0] += f.e2y * gpvz - f.e2z * gpvy;
        gd[1] += f.e2z * gpvx - f.e2x * gpvz;
        gd[2] += f.e2x * gpvy - f.e2y * gpvx;
        ge2x += gpvy * r.dz - gpvz * r.dy;
        ge2y += gpvz * r.dx - gpvx * r.dz;
        ge2z += gpvx * r.dy - gpvy * r.dx;
        // e1 = v1 - v0, e2 = v2 - v0, tv = o - v0
        atomicAdd(&at[0], -gtvx - ge1x - ge2x);
        atomicAdd(&at[1], -gtvy - ge1y - ge2y);
        atomicAdd(&at[2], -gtvz - ge1z - ge2z);
        atomicAdd(&at[3], ge1x);
        atomicAdd(&at[4], ge1y);
        atomicAdd(&at[5], ge1z);
        atomicAdd(&at[6], ge2x);
        atomicAdd(&at[7], ge2y);
        atomicAdd(&at[8], ge2z);
      }
    }
    for (int c = 0; c < 3; ++c) {
      d_o[3 * i + c] = go[c];
      d_d[3 * i + c] = gd[c];
    }
  }

  __syncthreads();
  for (int k = threadIdx.x; k < table_floats; k += blockDim.x) {
    const float g = acc[k];
    if (g == 0.0f) continue;
    if (k < 9 * rows) {
      atomicAdd(&d_tri[k], g);
    } else if (k < 28 * rows) {
      atomicAdd(&d_aux[k - 9 * rows], g);
    } else if (k < 28 * rows + 6 * num_lights) {
      atomicAdd(&d_lights[k - 28 * rows], g);
    } else {
      atomicAdd(&d_spheres[k - 28 * rows - 6 * num_lights], g);
    }
  }
}

size_t shade_table_bytes(int rows, int num_lights, int num_spheres) {
  return sizeof(float) * (28 * rows + 6 * num_lights + 11 * num_spheres);
}

}  // namespace cgrt

extern "C" {

int cgrt_shade_fwd(const float* o, const float* d, const int* prim, const int* bits, int n,
                   const float* tris, const float* aux, int rows, int num_tris,
                   const float* lights, int num_lights, const float* spheres, int num_spheres,
                   float* direct, float* ks, float* normal, float* position,
                   cudaStream_t stream) {
  if (n > 0) {
    cgrt::shade_fwd_kernel<<<cgrt::num_blocks(n), cgrt::kThreads,
                             cgrt::shade_table_bytes(rows, num_lights, num_spheres), stream>>>(
        o, d, prim, bits, n, tris, aux, rows, num_tris, lights, num_lights, spheres,
        num_spheres, direct, ks, normal, position);
  }
  return static_cast<int>(cudaGetLastError());
}

// The table cotangents d_tri, d_aux, d_lights, d_spheres are added to (the
// caller zeroes them); d_o and d_d are written.
int cgrt_shade_bwd(const float* o, const float* d, const int* prim, const int* bits, int n,
                   const float* tris, const float* aux, int rows, int num_tris,
                   const float* lights, int num_lights, const float* spheres, int num_spheres,
                   const float* g_direct, const float* g_ks, const float* g_normal,
                   const float* g_position, float* d_o, float* d_d, float* d_tri,
                   float* d_aux, float* d_lights, float* d_spheres, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = 2 * cgrt::shade_table_bytes(rows, num_lights, num_spheres);
  cudaError_t err = cudaFuncSetAttribute(cgrt::shade_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cgrt::shade_bwd_kernel,
                                                           cgrt::kThreads, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const int wave = sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = cgrt::num_blocks(n) < wave ? cgrt::num_blocks(n) : wave;
  cgrt::shade_bwd_kernel<<<blocks, cgrt::kThreads, smem, stream>>>(
      o, d, prim, bits, n, tris, aux, rows, num_tris, lights, num_lights, spheres, num_spheres,
      g_direct, g_ks, g_normal, g_position, d_o, d_d, d_tri, d_aux, d_lights, d_spheres);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

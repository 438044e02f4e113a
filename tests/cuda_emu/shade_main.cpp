// Host harness for csrc/shade.cu built against this directory's stand-in CUDA
// header (tests/test_torch_shade_memcheck.py).  Reads one launch's inputs
// from argv[1], each array into a heap buffer of exactly its size, runs the
// forward and then the backward kernel of the select path (cgrt_shade_fwd,
// cgrt_shade_bwd) or of the pregathered path (cgrt_shade_pre_fwd,
// cgrt_shade_pre_bwd), and writes their outputs to argv[2].
//
// Input: int64 pre (0 select, 1 pregathered), n, rows (select: tri/aux rows;
// pregathered: payload rows), num_tris, num_mats, L, S, Ls; then float32 o
// [n, 3], d [n, 3], int32 prim [n], int32 bits [n]; select: float32 tri
// [rows, 9], aux [rows, 19]; pregathered: float32 payload [rows, 19], mats
// [num_mats, 7]; float32 lights [L, 6], spheres [S, 11], sph [Ls, 6], fracs
// [Ls, n], and the cotangents g_direct, g_ks, g_normal, g_position, each [n,
// 3].  Output, float32: direct, ks, normal, position, d_o, d_d, each [n, 3];
// then d_tri [rows, 9] and d_aux [rows, 19], or d_payload [rows, 19] and
// d_mats [num_mats, 7]; then d_lights [L, 6], d_spheres [S, 11], d_sph [Ls, 6].
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "cuda_runtime.h"

extern "C" {
int cgrt_shade_fwd(const float* o, const float* d, const int* prim, const int* bits, int n,
                   const float* tris, const float* aux, int rows, int num_tris,
                   const float* lights, int num_lights, const float* spheres, int num_spheres,
                   const float* sph, int num_sph, const float* fracs, float* direct, float* ks,
                   float* normal, float* position, cudaStream_t stream);
int cgrt_shade_bwd(const float* o, const float* d, const int* prim, const int* bits, int n,
                   const float* tris, const float* aux, int rows, int num_tris,
                   const float* lights, int num_lights, const float* spheres, int num_spheres,
                   const float* sph, int num_sph, const float* fracs, const float* g_direct,
                   const float* g_ks, const float* g_normal, const float* g_position,
                   float* d_o, float* d_d, float* d_tri, float* d_aux, float* d_lights,
                   float* d_spheres, float* d_sph, cudaStream_t stream);
int cgrt_shade_pre_fwd(const float* o, const float* d, const int* prim, const int* bits, int n,
                       const float* payload, int num_tris, const float* mats, int num_mats,
                       const float* lights, int num_lights, const float* spheres,
                       int num_spheres, const float* sph, int num_sph, const float* fracs,
                       float* direct, float* ks, float* normal, float* position,
                       cudaStream_t stream);
int cgrt_shade_pre_bwd(const float* o, const float* d, const int* prim, const int* bits, int n,
                       const float* payload, int num_tris, const float* mats, int num_mats,
                       const float* lights, int num_lights, const float* spheres,
                       int num_spheres, const float* sph, int num_sph, const float* fracs,
                       const float* g_direct, const float* g_ks, const float* g_normal,
                       const float* g_position, float* d_o, float* d_d, float* d_payload,
                       float* d_mats, float* d_lights, float* d_spheres, float* d_sph,
                       cudaStream_t stream);
}

template <class T>
static T* read_array(FILE* f, long long count) {
  if (count == 0) return nullptr;
  T* p = new T[count];
  if (fread(p, sizeof(T), count, f) != static_cast<size_t>(count)) {
    fprintf(stderr, "short read\n");
    exit(2);
  }
  return p;
}

// A zeroed output of exactly count floats (none for 0).
static float* zeros(long long count) {
  if (count == 0) return nullptr;
  float* p = new float[count];
  memset(p, 0, sizeof(float) * count);
  return p;
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (f == nullptr) return 2;
  long long h[8];
  if (fread(h, sizeof(long long), 8, f) != 8) return 2;
  const bool pre = h[0] != 0;
  const long long n = h[1], rows = h[2], num_tris = h[3], num_mats = h[4];
  const long long nl = h[5], ns = h[6], nsph = h[7];
  const float* o = read_array<float>(f, 3 * n);
  const float* d = read_array<float>(f, 3 * n);
  const int* prim = read_array<int>(f, n);
  const int* bits = read_array<int>(f, n);
  const float* head0 = read_array<float>(f, pre ? 19 * rows : 9 * rows);  // payload or tri
  const float* head1 = read_array<float>(f, pre ? 7 * num_mats : 19 * rows);  // mats or aux
  const float* lights = read_array<float>(f, 6 * nl);
  const float* spheres = read_array<float>(f, 11 * ns);
  const float* sph = read_array<float>(f, 6 * nsph);
  const float* fracs = read_array<float>(f, nsph * n);
  const float* gc[4];
  for (auto& g : gc) g = read_array<float>(f, 3 * n);
  fclose(f);
  float* fwd[4];
  for (auto& x : fwd) x = zeros(3 * n);
  float* d_o = zeros(3 * n);
  float* d_d = zeros(3 * n);
  float* d_head0 = zeros(pre ? 19 * rows : 9 * rows);
  float* d_head1 = zeros(pre ? 7 * num_mats : 19 * rows);
  float* d_lights = zeros(6 * nl);
  float* d_spheres = zeros(11 * ns);
  float* d_sph = zeros(6 * nsph);
  const int N = static_cast<int>(n), L = static_cast<int>(nl), S = static_cast<int>(ns);
  const int Ls = static_cast<int>(nsph);
  int err;
  if (pre) {
    err = cgrt_shade_pre_fwd(o, d, prim, bits, N, head0, static_cast<int>(num_tris), head1,
                             static_cast<int>(num_mats), lights, L, spheres, S, sph, Ls, fracs,
                             fwd[0], fwd[1], fwd[2], fwd[3], nullptr);
    err = err ? err
              : cgrt_shade_pre_bwd(o, d, prim, bits, N, head0, static_cast<int>(num_tris), head1,
                                   static_cast<int>(num_mats), lights, L, spheres, S, sph, Ls,
                                   fracs, gc[0], gc[1], gc[2], gc[3], d_o, d_d, d_head0,
                                   d_head1, d_lights, d_spheres, d_sph, nullptr);
  } else {
    err = cgrt_shade_fwd(o, d, prim, bits, N, head0, head1, static_cast<int>(rows),
                         static_cast<int>(num_tris), lights, L, spheres, S, sph, Ls, fracs,
                         fwd[0], fwd[1], fwd[2], fwd[3], nullptr);
    err = err ? err
              : cgrt_shade_bwd(o, d, prim, bits, N, head0, head1, static_cast<int>(rows),
                               static_cast<int>(num_tris), lights, L, spheres, S, sph, Ls,
                               fracs, gc[0], gc[1], gc[2], gc[3], d_o, d_d, d_head0, d_head1,
                               d_lights, d_spheres, d_sph, nullptr);
  }
  if (err != 0) return 3;
  FILE* out = fopen(argv[2], "wb");
  if (out == nullptr) return 2;
  const struct {
    const float* p;
    long long count;
  } outs[] = {{fwd[0], 3 * n},
              {fwd[1], 3 * n},
              {fwd[2], 3 * n},
              {fwd[3], 3 * n},
              {d_o, 3 * n},
              {d_d, 3 * n},
              {d_head0, pre ? 19 * rows : 9 * rows},
              {d_head1, pre ? 7 * num_mats : 19 * rows},
              {d_lights, 6 * nl},
              {d_spheres, 11 * ns},
              {d_sph, 6 * nsph}};
  for (const auto& x : outs) {
    if (x.count && fwrite(x.p, sizeof(float), x.count, out) != static_cast<size_t>(x.count)) {
      return 2;
    }
  }
  fclose(out);
  return 0;
}

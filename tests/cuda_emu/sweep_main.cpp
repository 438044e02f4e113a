// Host harness for the brute-force sweep kernels (csrc/oracle.cu, trace.cu,
// record.cu) built against this directory's stand-in CUDA header
// (tests/test_torch_sweep_memcheck.py).  Reads one launch's inputs from
// argv[1], each array into a heap buffer of exactly its size, runs one entry
// point and writes its outputs, each from a buffer of exactly its size, to
// argv[2].
//
// Input: int64 kind (0 cgrt_closest, 1 cgrt_anyhit, 2 cgrt_bounce,
// 3 cgrt_trace, 4 cgrt_record_trace, 5 cgrt_bounce_refl), n, T, L, S,
// depth, quirk, has_t_max, max_grid (emu_max_grid: 0 = the launch's grid);
// then float32 o [n, 3], d [n, 3], t_max [n] (if
// has_t_max), tri [T, 9], aux [T, 19] (kinds 3-5), lights [L, 3] (kinds 2,
// 4, 5) or [L, 6] (kind 3), spheres [S, 11] (kind 3).  Output, by kind:
// 0: t, slot, u, v [n]; 1: hit [n] (uint8); 2: t, slot, u, v, bits [n];
// 3: rgb [n, 3]; 4: t, slot, u, v, bits [depth, n], o_next, d_next
// [depth - 1, n, 3], active [depth - 1, n] (uint8); 5: t, slot, u, v, bits
// [n], position, reflection [n, 3], reflective [n] (uint8).  slot and bits
// are int32, the rest float32 unless marked.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "cuda_runtime.h"

extern "C" {
int cgrt_closest(const float* o, const float* d, const float* t_max, int n, const float* tris,
                 int num_tris, float* t, int* slot, float* u, float* v, cudaStream_t stream);
int cgrt_anyhit(const float* o, const float* d, const float* t_max, int n, const float* tris,
                int num_tris, uint8_t* hit, cudaStream_t stream);
int cgrt_bounce(const float* o, const float* d, const float* t_max, int n, const float* tris,
                int num_tris, const float* lights, int num_lights, float* t, int* slot,
                float* u, float* v, int* bits, cudaStream_t stream);
int cgrt_trace(const float* o, const float* d, int n, const float* tris, int num_tris,
               const float* aux, const float* spheres, int num_spheres, const float* lights,
               int num_lights, int max_depth, int quirk_ks_z, float* rgb, cudaStream_t stream);
int cgrt_record_trace(const float* o, const float* d, int n, const float* tris, int num_tris,
                      const float* aux, const float* lights, int num_lights, int max_depth,
                      int quirk_ks_z, float* t, int* slot, float* u, float* v, int* bits,
                      float* o_next, float* d_next, uint8_t* active, cudaStream_t stream);
int cgrt_bounce_refl(const float* o, const float* d, const float* t_max, int n,
                     const float* tris, int num_tris, const float* aux, const float* lights,
                     int num_lights, int quirk_ks_z, float* t, int* slot, float* u, float* v,
                     int* bits, float* position, float* refl, uint8_t* reflective,
                     cudaStream_t stream);
}

static FILE* g_in = nullptr;

template <class T>
static T* read_array(long long count) {
  if (count == 0) return nullptr;
  T* p = new T[count];
  if (fread(p, sizeof(T), count, g_in) != static_cast<size_t>(count)) {
    fprintf(stderr, "short read\n");
    exit(2);
  }
  return p;
}

// The outputs in the order they are written: pointer, element size, count.
struct Out {
  void* p;
  size_t size;
  long long count;
};
static std::vector<Out> g_outs;

template <class T>
static T* output(long long count) {
  T* p = count == 0 ? nullptr : new T[count]();
  g_outs.push_back(Out{p, sizeof(T), count});
  return p;
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  g_in = fopen(argv[1], "rb");
  if (g_in == nullptr) return 2;
  long long h[9];
  if (fread(h, sizeof(long long), 9, g_in) != 9) return 2;
  emu_max_grid = static_cast<unsigned>(h[8]);
  const long long kind = h[0], n = h[1], nt = h[2], nl = h[3], ns = h[4], depth = h[5];
  const int quirk = static_cast<int>(h[6]);
  const float* o = read_array<float>(3 * n);
  const float* d = read_array<float>(3 * n);
  const float* t_max = h[7] ? read_array<float>(n) : nullptr;
  const float* tri = read_array<float>(9 * nt);
  const float* aux = kind >= 3 ? read_array<float>(19 * nt) : nullptr;
  const float* lights = kind == 3 ? read_array<float>(6 * nl)
                                  : (kind == 1 || kind == 0 ? nullptr : read_array<float>(3 * nl));
  const float* spheres = kind == 3 ? read_array<float>(11 * ns) : nullptr;
  fclose(g_in);
  const int N = static_cast<int>(n), T = static_cast<int>(nt), L = static_cast<int>(nl);
  const int D = static_cast<int>(depth);
  int err = 0;
  switch (kind) {
    case 0: {
      float* t = output<float>(n);
      int* slot = output<int>(n);
      float* u = output<float>(n);
      float* v = output<float>(n);
      err = cgrt_closest(o, d, t_max, N, tri, T, t, slot, u, v, nullptr);
      break;
    }
    case 1:
      err = cgrt_anyhit(o, d, t_max, N, tri, T, output<uint8_t>(n), nullptr);
      break;
    case 2: {
      float* t = output<float>(n);
      int* slot = output<int>(n);
      float* u = output<float>(n);
      float* v = output<float>(n);
      int* bits = output<int>(n);
      err = cgrt_bounce(o, d, t_max, N, tri, T, lights, L, t, slot, u, v, bits, nullptr);
      break;
    }
    case 3:
      err = cgrt_trace(o, d, N, tri, T, aux, spheres, static_cast<int>(ns), lights, L, D, quirk,
                       output<float>(3 * n), nullptr);
      break;
    case 4: {
      float* t = output<float>(depth * n);
      int* slot = output<int>(depth * n);
      float* u = output<float>(depth * n);
      float* v = output<float>(depth * n);
      int* bits = output<int>(depth * n);
      float* o_next = output<float>((depth - 1) * n * 3);
      float* d_next = output<float>((depth - 1) * n * 3);
      uint8_t* active = output<uint8_t>((depth - 1) * n);
      err = cgrt_record_trace(o, d, N, tri, T, aux, lights, L, D, quirk, t, slot, u, v, bits,
                              o_next, d_next, active, nullptr);
      break;
    }
    case 5: {
      float* t = output<float>(n);
      int* slot = output<int>(n);
      float* u = output<float>(n);
      float* v = output<float>(n);
      int* bits = output<int>(n);
      float* pos = output<float>(3 * n);
      float* refl = output<float>(3 * n);
      uint8_t* reflective = output<uint8_t>(n);
      err = cgrt_bounce_refl(o, d, t_max, N, tri, T, aux, lights, L, quirk, t, slot, u, v, bits,
                             pos, refl, reflective, nullptr);
      break;
    }
    default:
      return 2;
  }
  if (err != 0) return 3;
  FILE* out = fopen(argv[2], "wb");
  if (out == nullptr) return 2;
  for (const Out& x : g_outs) {
    if (x.count && fwrite(x.p, x.size, x.count, out) != static_cast<size_t>(x.count)) return 2;
  }
  fclose(out);
  return 0;
}

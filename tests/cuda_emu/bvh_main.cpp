// Host harness for csrc/bvh4.cu built against this directory's stand-in CUDA
// header (tests/test_torch_bvh_memcheck.py).  Reads one launch's inputs from
// argv[1], each array into a heap buffer of exactly its size, calls
// cgrt_bvh4_closest, cgrt_bvh4_anyhit or cgrt_bvh4_bounce twice (the bounce
// stages its lights in shared memory, which the first pass fills thread by
// thread: see cuda_runtime.h) and writes the second pass's outputs to argv[2].
//
// Input: int64 kind (0 closest, 1 any hit, 2 bounce), n, width, num_nodes,
// num_tris, has_t_max, num_lights, 0; then float32 o [n, 3], d [n, 3], t_max
// [n] (if has_t_max), the tree's float32 boxes [num_nodes, 6 width], int32
// meta [num_nodes, 2 width], int32 nchild [num_nodes], float32 tris
// [num_tris, 9], int32 slot_to_prim [num_tris], float32 lights [num_lights,
// 3] (kind 2).  Output: float32 t, int32 prim, float32 u, float32 v, int32
// bits (kind 2), each [n]; or uint8 hit [n] (kind 1).
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "cuda_runtime.h"

extern "C" {
int cgrt_bvh4_closest(const float* o, const float* d, const float* t_max, int n, int width,
                      const float* boxes, const int* meta, const int* nchild, const float* tris,
                      const int* slot_to_prim, float* t, int* prim, float* u, float* v,
                      cudaStream_t stream);
int cgrt_bvh4_anyhit(const float* o, const float* d, const float* t_max, int n, int width,
                     const float* boxes, const int* meta, const int* nchild, const float* tris,
                     const int* slot_to_prim, uint8_t* hit, cudaStream_t stream);
int cgrt_bvh4_bounce(const float* o, const float* d, const float* t_max, int n, int width,
                     const float* boxes, const int* meta, const int* nchild, const float* tris,
                     const int* slot_to_prim, const float* lights, int num_lights, float* t,
                     int* prim, float* u, float* v, int* bits, cudaStream_t stream);
}

// The bounce kernel's dynamic shared memory: the staged light positions.
namespace cgrt {
float s_light[EMU_SHARED_FLOATS];
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

template <class T>
static void write_array(FILE* f, const T* p, long long count) {
  if (fwrite(p, sizeof(T), count, f) != static_cast<size_t>(count)) exit(2);
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (f == nullptr) return 2;
  long long h[8];
  if (fread(h, sizeof(long long), 8, f) != 8) return 2;
  const long long kind = h[0], n = h[1], w = h[2], nodes = h[3], num_tris = h[4];
  const long long num_lights = h[6];
  const float* o = read_array<float>(f, 3 * n);
  const float* d = read_array<float>(f, 3 * n);
  const float* t_max = read_array<float>(f, h[5] ? n : 0);
  const float* boxes = read_array<float>(f, 6 * w * nodes);
  const int* meta = read_array<int>(f, 2 * w * nodes);
  const int* nchild = read_array<int>(f, nodes);
  const float* tris = read_array<float>(f, 9 * num_tris);
  const int* slot_to_prim = read_array<int>(f, num_tris);
  const float* lights = read_array<float>(f, kind == 2 ? 3 * num_lights : 0);
  fclose(f);
  if (kind == 2 && 3 * num_lights > EMU_SHARED_FLOATS) return 2;
  float* t = new float[n];
  int* prim = new int[n];
  float* u = new float[n];
  float* v = new float[n];
  int* bits = new int[n];
  uint8_t* hit = new uint8_t[n];
  const int width = static_cast<int>(w);
  for (int pass = 0; pass < 2; ++pass) {
    int err;
    if (kind == 0) {
      err = cgrt_bvh4_closest(o, d, t_max, n, width, boxes, meta, nchild, tris, slot_to_prim, t,
                              prim, u, v, nullptr);
    } else if (kind == 1) {
      err = cgrt_bvh4_anyhit(o, d, t_max, n, width, boxes, meta, nchild, tris, slot_to_prim, hit,
                             nullptr);
    } else {
      err = cgrt_bvh4_bounce(o, d, t_max, n, width, boxes, meta, nchild, tris, slot_to_prim,
                             lights, static_cast<int>(num_lights), t, prim, u, v, bits, nullptr);
    }
    if (err != 0) return 3;
  }
  FILE* out = fopen(argv[2], "wb");
  if (out == nullptr) return 2;
  if (kind == 1) {
    write_array(out, hit, n);
  } else {
    write_array(out, t, n);
    write_array(out, prim, n);
    write_array(out, u, n);
    write_array(out, v, n);
    if (kind == 2) write_array(out, bits, n);
  }
  fclose(out);
  return 0;
}

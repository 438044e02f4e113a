// Host harness for csrc/soft.cu built against this directory's stand-in CUDA
// header (tests/test_torch_soft_memcheck.py).  Reads one launch's inputs
// from argv[1], each array into a heap buffer of exactly its size, calls
// cgrt_soft_brute or cgrt_soft_bvh4 twice (the second on zeroed counts:
// see cuda_runtime.h) and writes the counts [n] int32 to argv[2].
//
// Input: int64 kind (0 brute, else the tree's node width), n, num_samples,
// num_tris, num_nodes, has_valid, has_gauss, k0, k1, offset; then float32 pos
// [n, 3], uint8 valid [n] (if has_valid), float32 light [4], float32 tris
// [num_tris, 9], the tree's float32 boxes [num_nodes, 6 width], int32 meta
// [num_nodes, 2 width] and int32 nchild [num_nodes] (a tree), float32 gauss
// [n, num_samples, 3] (if has_gauss).
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "cuda_runtime.h"

extern "C" {
int cgrt_soft_brute(const float* pos, const uint8_t* valid, int n, const float* light,
                    const float* tris, int num_tris, int num_samples, unsigned k0, unsigned k1,
                    unsigned offset, const float* gauss, int* counts, cudaStream_t stream);
int cgrt_soft_bvh4(const float* pos, const uint8_t* valid, int n, const float* light, int width,
                   const float* boxes, const int* meta, const int* nchild, const float* tris,
                   int num_samples, unsigned k0, unsigned k1, unsigned offset,
                   const float* gauss, int* counts, cudaStream_t stream);
}

// The brute kernel's dynamic shared memory: the staged triangle table.
namespace cgrt {
float s_tri[EMU_SHARED_FLOATS];
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

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (f == nullptr) return 2;
  long long h[10];
  if (fread(h, sizeof(long long), 10, f) != 10) return 2;
  const long long kind = h[0], n = h[1], s = h[2], num_tris = h[3], nodes = h[4];
  const float* pos = read_array<float>(f, 3 * n);
  const uint8_t* valid = read_array<uint8_t>(f, h[5] ? n : 0);
  const float* light = read_array<float>(f, 4);
  const float* tris = read_array<float>(f, 9 * num_tris);
  const float* boxes = read_array<float>(f, 6 * kind * nodes);
  const int* meta = read_array<int>(f, 2 * kind * nodes);
  const int* nchild = read_array<int>(f, kind ? nodes : 0);
  const float* gauss = read_array<float>(f, h[6] ? 3 * n * s : 0);
  fclose(f);
  if (!kind && 9 * num_tris > EMU_SHARED_FLOATS) return 2;
  int* counts = new int[n];
  for (int pass = 0; pass < 2; ++pass) {
    memset(counts, 0, sizeof(int) * n);
    const unsigned k0 = static_cast<unsigned>(h[7]), k1 = static_cast<unsigned>(h[8]);
    const unsigned offset = static_cast<unsigned>(h[9]);
    const int err = kind ? cgrt_soft_bvh4(pos, valid, n, light, static_cast<int>(kind), boxes,
                                          meta, nchild, tris, s, k0, k1, offset, gauss, counts,
                                          nullptr)
                         : cgrt_soft_brute(pos, valid, n, light, tris, num_tris, s, k0, k1,
                                           offset, gauss, counts, nullptr);
    if (err != 0) return 3;
  }
  FILE* out = fopen(argv[2], "wb");
  if (out == nullptr || fwrite(counts, sizeof(int), n, out) != static_cast<size_t>(n)) return 2;
  fclose(out);
  return 0;
}

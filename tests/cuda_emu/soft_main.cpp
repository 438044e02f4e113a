// Host harness for csrc/soft.cu built against this directory's stand-in CUDA
// header (tests/test_torch_soft_memcheck.py, tests/test_torch_soft_cull.py).
// Reads one launch's inputs from argv[1], each array into a heap buffer of
// exactly its size, calls cgrt_soft_brute or cgrt_soft_bvh4 twice (the
// second on zeroed counts and tallies, the lists' scratch left as the first
// call wrote it) and writes the counts [n] int32 to argv[2], then the second
// call's tally: the brute sampler's two uint64 (tests kept, tests of full
// sweeps), a tree sampler's three (live samples, nodes expanded, triangles
// tested), then its list tally's six uint64 (marked points, listed points,
// triangles kept, the point pass's nodes expanded and triangles tested,
// points whose walks a path leads), its kept [n] int32 and its lists [n, K]
// int32 (K = cgrt_soft_list_max()).
// argv[3], where given, caps the grid of emu_launch_threads (emu_max_grid),
// so that the blocks stride.
//
// Input: int64 kind (0 brute, else the tree's node width), n, num_samples,
// num_tris, num_nodes, has_order, has_gauss, k0, k1, offset; then float32
// pos [n, 3], int32 order [n + 1] and count [1] (if has_order), float32
// light [4]; the brute sampler's
// float32 triangles [num_tris, 9], or the tree's float32 node records
// [num_nodes, 8 width] and triangle rows [num_tris, 12]; float32 gauss [n,
// num_samples, 3] (if has_gauss).
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "cuda_runtime.h"

extern "C" {
int cgrt_soft_brute(const float* pos, const int* order, const int* count, int n,
                    const float* light, const float* tris, int num_tris, int num_samples,
                    const unsigned* key, unsigned offset, const float* gauss, int* counts,
                    unsigned long long* tally, cudaStream_t stream);
int cgrt_soft_bvh4(const float* pos, const int* order, const int* count, int n,
                   const float* light, int width, const float* nodes, const float* rows,
                   int num_nodes, int num_samples, const unsigned* key, unsigned offset,
                   const float* gauss, int* counts, unsigned long long* tally, int* lists,
                   int* kept, int* up, unsigned long long* list_tally, cudaStream_t stream);
int cgrt_soft_list_max();
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
  if (argc != 3 && argc != 4) return 2;
  if (argc == 4) emu_max_grid = static_cast<unsigned>(atoi(argv[3]));
  FILE* f = fopen(argv[1], "rb");
  if (f == nullptr) return 2;
  long long h[10];
  if (fread(h, sizeof(long long), 10, f) != 10) return 2;
  const long long kind = h[0], n = h[1], s = h[2], num_tris = h[3], nodes = h[4];
  const float* pos = read_array<float>(f, 3 * n);
  const int* order = read_array<int>(f, h[5] ? n + 1 : 0);
  const int* count = read_array<int>(f, h[5] ? 1 : 0);
  const float* light = read_array<float>(f, 4);
  const float* tris = read_array<float>(f, kind ? 0 : 9 * num_tris);
  // The tree's tables as 16-byte rows, as the kernel reads them.
  const float4* records = read_array<float4>(f, 2 * kind * nodes);
  const float4* rows = read_array<float4>(f, kind ? 3 * num_tris : 0);
  const float* gauss = read_array<float>(f, h[6] ? 3 * n * s : 0);
  fclose(f);
  int* counts = new int[n];
  // The tally in a heap buffer of exactly its size, as the wrapper's.
  const int tally_size = kind ? 3 : 2;
  unsigned long long* tally = new unsigned long long[tally_size];
  // The point pass's scratch and tally, each of exactly its size.
  const long long list_size = kind ? 2 * n * cgrt_soft_list_max() : 0;
  int* lists = kind ? new int[list_size] : nullptr;
  int* kept = kind ? new int[n] : nullptr;
  int* up = kind ? new int[nodes] : nullptr;
  unsigned long long* list_tally = kind ? new unsigned long long[6] : nullptr;
  for (long long q = 0; kind && q < n; ++q) kept[q] = -2;  // never written: -2
  for (long long q = 0; q < list_size; ++q) lists[q] = -2;
  for (int pass = 0; pass < 2; ++pass) {
    memset(counts, 0, sizeof(int) * n);
    memset(tally, 0, sizeof(unsigned long long) * tally_size);
    if (kind) memset(list_tally, 0, sizeof(unsigned long long) * 6);
    // The key words in a heap buffer of exactly two, as the wrapper's
    // device copy (none for a table launch).
    unsigned* key = h[6] ? nullptr : new unsigned[2]{static_cast<unsigned>(h[7]),
                                                     static_cast<unsigned>(h[8])};
    const unsigned offset = static_cast<unsigned>(h[9]);
    const int err =
        kind ? cgrt_soft_bvh4(pos, order, count, n, light, static_cast<int>(kind),
                              reinterpret_cast<const float*>(records),
                              reinterpret_cast<const float*>(rows), static_cast<int>(nodes), s,
                              key, offset, gauss, counts, tally, lists, kept, up, list_tally,
                              nullptr)
             : cgrt_soft_brute(pos, order, count, n, light, tris, num_tris, s, key, offset,
                               gauss, counts, tally, nullptr);
    delete[] key;
    if (err != 0) return 3;
  }
  FILE* out = fopen(argv[2], "wb");
  if (out == nullptr || fwrite(counts, sizeof(int), n, out) != static_cast<size_t>(n) ||
      fwrite(tally, sizeof(unsigned long long), tally_size, out) !=
          static_cast<size_t>(tally_size))
    return 2;
  if (kind && (fwrite(list_tally, sizeof(unsigned long long), 6, out) != 6 ||
               fwrite(kept, sizeof(int), n, out) != static_cast<size_t>(n) ||
               fwrite(lists, sizeof(int), list_size, out) != static_cast<size_t>(list_size)))
    return 2;
  fclose(out);
  return 0;
}

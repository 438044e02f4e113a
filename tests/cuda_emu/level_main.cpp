// Host harness for csrc/level.cu built against this directory's stand-in CUDA
// header (tests/test_torch_level_memcheck.py), in one translation unit.
// Reads one level's inputs from argv[1], each array into a heap buffer of
// exactly its size, runs cgrt_level (where the shadow bits are given and
// there is no spherical light), then cgrt_level_surface and
// cgrt_level_shade on the surface it wrote, and writes their outputs to
// argv[2].
//
// Input: int64 n, V, T, M, S, L, Ls, quirk, last, has_state, use_bits,
// max_grid (emu_max_grid: 0 for no cap); then o [n, 3], d [n, 3] float32,
// prim [n] int32; bits [n] int32 (use_bits) or masks [L, n] uint8; fracs
// [Ls, n] float32; with has_state active [n] uint8, throughput [n, 3] and
// color [n, 3] float32; vertices [V, 3], normals [V, 3], triangles [T, 3]
// int32, tri_material [T] int32, kd [M, 3], ks [M, 3], shininess [M],
// sphere center [S, 3], radius [S], kd [S, 3], ks [S, 3], shininess [S],
// point lights position [L, 3], color [L, 3], spherical lights position
// [Ls, 3], color [Ls, 3].
// Output, float32 (the uint8 fields as 0.0 or 1.0): where cgrt_level ran,
// its color [n, 3] and, unless last, throughput [n, 3], active [n], o_next
// [n, 3], d_next [n, 3]; then the surface's position, normal, kd, ks [n, 3],
// shininess [n], valid [n]; then cgrt_level_shade's outputs as cgrt_level's.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "cuda_runtime.h"
// csrc/level.cu with its launch rewritten to emu_launch_threads (the test
// writes it beside the build).
#include "level_emu.cpp"

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
static T* empty(long long count) {
  if (count == 0) return nullptr;
  T* p = new T[count];
  memset(p, 0xFF, sizeof(T) * count);  // not zero: every element must be written
  return p;
}

static std::vector<float> out;

template <class T>
static void emit(const T* p, long long count) {
  for (long long i = 0; i < count; ++i) out.push_back(static_cast<float>(p[i]));
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (f == nullptr) return 2;
  long long h[12];
  if (fread(h, sizeof(long long), 12, f) != 12) return 2;
  const long long n = h[0], nv = h[1], nt = h[2], nm = h[3], ns = h[4], nl = h[5], nsl = h[6];
  const bool quirk = h[7] != 0, last = h[8] != 0, has_state = h[9] != 0, use_bits = h[10] != 0;
  emu_max_grid = static_cast<unsigned>(h[11]);

  cgrt_levels::LevelArgs a{};
  a.o = read_array<float>(f, 3 * n);
  a.d = read_array<float>(f, 3 * n);
  a.prim = read_array<int32_t>(f, n);
  a.n = static_cast<int32_t>(n);
  if (use_bits) {
    a.bits = read_array<int32_t>(f, n);
  } else {
    a.masks = read_array<uint8_t>(f, nl * n);
  }
  a.fracs = read_array<float>(f, nsl * n);
  if (has_state) {
    a.active = read_array<uint8_t>(f, n);
    a.throughput = read_array<float>(f, 3 * n);
    a.color = read_array<float>(f, 3 * n);
  }
  a.vertices = read_array<float>(f, 3 * nv);
  a.normals = read_array<float>(f, 3 * nv);
  a.triangles = read_array<int32_t>(f, 3 * nt);
  a.tri_material = read_array<int32_t>(f, nt);
  a.mat_kd = read_array<float>(f, 3 * nm);
  a.mat_ks = read_array<float>(f, 3 * nm);
  a.mat_shininess = read_array<float>(f, nm);
  a.num_tris = static_cast<int32_t>(nt);
  a.sph_center = read_array<float>(f, 3 * ns);
  a.sph_radius = read_array<float>(f, ns);
  a.sph_kd = read_array<float>(f, 3 * ns);
  a.sph_ks = read_array<float>(f, 3 * ns);
  a.sph_shininess = read_array<float>(f, ns);
  a.num_spheres = static_cast<int32_t>(ns);
  a.pl_position = read_array<float>(f, 3 * nl);
  a.pl_color = read_array<float>(f, 3 * nl);
  a.num_pl = static_cast<int32_t>(nl);
  a.sl_position = read_array<float>(f, 3 * nsl);
  a.sl_color = read_array<float>(f, 3 * nsl);
  a.num_sl = static_cast<int32_t>(nsl);
  a.quirk_ks_z = quirk;
  a.last = last;
  fclose(f);

  const cgrt_levels::LevelArgs* args = &a;
  auto level_outputs = [&] {
    a.color_out = empty<float>(3 * n);
    if (!last) {
      a.throughput_out = empty<float>(3 * n);
      a.active_out = empty<uint8_t>(n);
      a.o_next = empty<float>(3 * n);
      a.d_next = empty<float>(3 * n);
    }
  };
  auto emit_level = [&] {
    emit(a.color_out, 3 * n);
    if (!last) {
      emit(a.throughput_out, 3 * n);
      emit(a.active_out, n);
      emit(a.o_next, 3 * n);
      emit(a.d_next, 3 * n);
    }
  };
  if (use_bits && nsl == 0) {
    level_outputs();
    if (cgrt_level(args, nullptr) != 0) return 3;
    emit_level();
  }
  a.position = empty<float>(3 * n);
  a.normal = empty<float>(3 * n);
  a.kd = empty<float>(3 * n);
  a.ks = empty<float>(3 * n);
  a.shininess = empty<float>(n);
  a.valid = empty<uint8_t>(n);
  if (cgrt_level_surface(args, nullptr) != 0) return 3;
  for (float* p : {a.position, a.normal, a.kd, a.ks}) emit(p, 3 * n);
  emit(a.shininess, n);
  emit(a.valid, n);
  level_outputs();
  if (cgrt_level_shade(args, nullptr) != 0) return 3;
  emit_level();

  FILE* o = fopen(argv[2], "wb");
  if (o == nullptr) return 2;
  if (fwrite(out.data(), sizeof(float), out.size(), o) != out.size()) return 2;
  fclose(o);
  return 0;
}

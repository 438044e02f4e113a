// Host harness for csrc/sweep.cuh's Moller-Trumbore tests built against this
// directory's stand-in CUDA header (tests/test_torch_soft_mt.py).  Reads n
// cases from argv[1] and writes, per case, four uint8 [n] columns to
// argv[2]: mt(...) && t < t_max (the full test), mt_blocks(...) (the
// any-hit test with early exits), |det| > kMtEps (where the case falls
// against the determinant's threshold), and whether mt_early(...) (the
// closest sweep's test) decides as the full test with mt's t, u and v bit
// for bit where it hits.
//
// Input: int64 n; then float32 rays [n, 6] (origin, direction), triangles
// [n, 9] (v0, e1, e2) and t_max [n].
#include <cstdio>
#include <cstring>
#include <vector>

#include "cuda_runtime.h"
#include "sweep.cuh"

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (f == nullptr) return 2;
  long long n = 0;
  if (fread(&n, sizeof(n), 1, f) != 1 || n <= 0) return 2;
  std::vector<float> rays(6 * n), tris(9 * n), t_max(n);
  if (fread(rays.data(), sizeof(float), rays.size(), f) != rays.size() ||
      fread(tris.data(), sizeof(float), tris.size(), f) != tris.size() ||
      fread(t_max.data(), sizeof(float), t_max.size(), f) != t_max.size()) {
    return 2;
  }
  fclose(f);
  std::vector<uint8_t> full(n), early(n), det_ok(n), closer(n);
  for (long long i = 0; i < n; ++i) {
    const float* q = rays.data() + 6 * i;
    const cgrt::Ray r{q[0], q[1], q[2], q[3], q[4], q[5]};
    const float* tri = tris.data() + 9 * i;
    const float4 v0 = make_float4(tri[0], tri[1], tri[2], 0.0f);
    const float4 e1 = make_float4(tri[3], tri[4], tri[5], 0.0f);
    const float4 e2 = make_float4(tri[6], tri[7], tri[8], 0.0f);
    float t, u, v;
    full[i] = cgrt::mt(v0, e1, e2, r, t, u, v) && t < t_max[i];
    early[i] = cgrt::mt_blocks(v0, e1, e2, r, t_max[i]);
    float te, ue, ve;
    const bool hit = cgrt::mt_early(v0, e1, e2, r, t_max[i], te, ue, ve);
    closer[i] = hit == static_cast<bool>(full[i]) &&
                (!hit || (memcmp(&t, &te, 4) == 0 && memcmp(&u, &ue, 4) == 0 &&
                          memcmp(&v, &ve, 4) == 0));
    const float px = r.dy * tri[8] - r.dz * tri[7];
    const float py = r.dz * tri[6] - r.dx * tri[8];
    const float pz = r.dx * tri[7] - r.dy * tri[6];
    det_ok[i] = fabsf(tri[3] * px + tri[4] * py + tri[5] * pz) > cgrt::kMtEps;
  }
  FILE* out = fopen(argv[2], "wb");
  if (out == nullptr) return 2;
  for (const auto* col : {&full, &early, &det_ok, &closer}) {
    if (fwrite(col->data(), 1, n, out) != static_cast<size_t>(n)) return 2;
  }
  fclose(out);
  return 0;
}

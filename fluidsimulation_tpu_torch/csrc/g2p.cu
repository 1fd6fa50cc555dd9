// Fused FLIP gather: per particle, the FLIP velocity and the next step's
// RK3 stage 1, both interpolated at the particle.
//
// Replaces fluidsimulation_tpu/core/pallas_pairpack.py::_pair_pack_component
// (via pack_mac3_pair_pallas) together with the packed pair interpolation it
// feeds (core/interp_packed.py::interp_mac3_packed_pair_vec, called from
// ops/flip.py::flip_update_carry). The pair pack exists only so that the
// TPU can gather 1 KB rows (pallas_pairpack.py:31-33); what the step needs
// from it is two interpolations at each particle:
//   diff = interp(du, dv, dw)   with dg = g - (1-alpha) * g_old  (PyTorch)
//   k1   = interp(u, v, w)
//   vel' = (1-alpha) * vel + diff
// with the semantics of core/interp.py::interp_mac3, including the top-edge
// index decrements: min(floor(n), m-2) on normal axes and min(floor(e), m-1)
// on the staggered axis.
//
// Bound on the H100: device-memory bytes of the particle streams. A
// particle reads 24 B (pos, vel), gathers 2 x 3 x 8 grid values and writes
// 24 B (vel', k1): 96 MB of particle traffic at 1M particles, ~29 us at
// 3.35 TB/s. The six grids (6 x 8.4 MB at 128^3) sit in L2, and particles
// that are near in index are near in space (dam-break seeding order), so
// the gathers mostly hit L2.
// Design: one thread per particle, one pass in place of the pack plus two
// packed gathers. Compiled with -fmad=false, so each lerp rounds like the
// plain version's separate multiply and add. A particle with a NaN
// coordinate reads in-range cells and returns NaN for vel' and k1, as the
// plain version does.
#include "common.cuh"

namespace {

struct Split {
  int i;
  float f;
};

// The NaN rule (core/interp.py): fmaxf maps a NaN coordinate to the lower
// bound, which keeps the index in range; the fraction takes the NaN back, as
// the plain version's clamp keeps it, so every lerp of the particle is NaN.
// A finite coordinate is untouched.
__device__ __forceinline__ float keep_nan(float coord, float frac) {
  return isnan(coord) ? coord : frac;
}

// Clamp to [0, m-1]; floor, but at most m-2 (Simulation3D.h:61,70).
__device__ __forceinline__ Split split_normal(float coord, int m) {
  const float n = fminf(fmaxf(coord, 0.0f), static_cast<float>(m) - 1.0f);
  const float i = fminf(floorf(n), static_cast<float>(m) - 2.0f);
  return {static_cast<int>(i), keep_nan(coord, n - i)};
}

// Clamp coord+0.5 to [0, m]; floor, but at most m-1 (Simulation3D.h:65,73).
__device__ __forceinline__ Split split_extended(float coord, int m) {
  const float c = coord + 0.5f;
  const float e = fminf(fmaxf(c, 0.0f), static_cast<float>(m));
  const float i = fminf(floorf(e), static_cast<float>(m) - 1.0f);
  return {static_cast<int>(i), keep_nan(c, e - i)};
}

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return a + (b - a) * t;
}

// Trilinear interpolation of the grid g of shape (., sy, sz), in the lerp
// order of core/interp.py::_trilerp.
__device__ __forceinline__ float trilerp(const float* __restrict__ g, int sy,
                                         int sz, Split x, Split y, Split z) {
  const long long dx = static_cast<long long>(sy) * sz;
  const long long dy = sz;
  const float* c = g + (static_cast<long long>(x.i) * sy + y.i) * sz + z.i;
  const float t00 = lerp(c[0], c[dx], x.f);
  const float t10 = lerp(c[dy], c[dx + dy], x.f);
  const float t01 = lerp(c[1], c[dx + 1], x.f);
  const float t11 = lerp(c[dy + 1], c[dx + dy + 1], x.f);
  const float tx0 = lerp(t00, t10, y.f);
  const float tx1 = lerp(t01, t11, y.f);
  return lerp(tx0, tx1, z.f);
}

__global__ void g2p_flip_kernel(const float* __restrict__ pos,
                                const float* __restrict__ vel,
                                const float* __restrict__ du,
                                const float* __restrict__ dv,
                                const float* __restrict__ dw,
                                const float* __restrict__ u,
                                const float* __restrict__ v,
                                const float* __restrict__ w,
                                float* __restrict__ vel_out,
                                float* __restrict__ k1, long long n, int nx,
                                int ny, int nz, float beta) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= n) return;
  const float pi = pos[3 * t + 0] * static_cast<float>(nx);
  const float pj = pos[3 * t + 1] * static_cast<float>(ny);
  const float pk = pos[3 * t + 2] * static_cast<float>(nz);
  const Split I = split_normal(pi, nx), J = split_normal(pj, ny),
              K = split_normal(pk, nz);
  const Split EI = split_extended(pi, nx), EJ = split_extended(pj, ny),
              EK = split_extended(pk, nz);

  // U is (nx+1, ny, nz), V is (nx, ny+1, nz), W is (nx, ny, nz+1).
  const float diff_u = trilerp(du, ny, nz, EI, J, K);
  const float diff_v = trilerp(dv, ny + 1, nz, I, EJ, K);
  const float diff_w = trilerp(dw, ny, nz + 1, I, J, EK);
  k1[3 * t + 0] = trilerp(u, ny, nz, EI, J, K);
  k1[3 * t + 1] = trilerp(v, ny + 1, nz, I, EJ, K);
  k1[3 * t + 2] = trilerp(w, ny, nz + 1, I, J, EK);
  vel_out[3 * t + 0] = beta * vel[3 * t + 0] + diff_u;
  vel_out[3 * t + 1] = beta * vel[3 * t + 1] + diff_v;
  vel_out[3 * t + 2] = beta * vel[3 * t + 2] + diff_w;
}

}  // namespace

extern "C" int fst_g2p_flip(const float* pos, const float* vel,
                            const float* du, const float* dv, const float* dw,
                            const float* u, const float* v, const float* w,
                            float* vel_out, float* k1, long long n, int nx,
                            int ny, int nz, float beta, void* stream) {
  if (n > 0) {
    g2p_flip_kernel<<<fst::blocks_for(n), fst::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        pos, vel, du, dv, dw, u, v, w, vel_out, k1, n, nx, ny, nz, beta);
  }
  return static_cast<int>(cudaGetLastError());
}

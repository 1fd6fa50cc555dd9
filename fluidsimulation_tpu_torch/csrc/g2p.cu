// Fused FLIP gather: per particle, the FLIP velocity and the next step's
// RK3 stage 1, both interpolated at the particle, walked in CSR order.
//
// Replaces fluidsimulation_tpu/core/pallas_pairpack.py::_pair_pack_component
// (via pack_mac3_pair_pallas) together with the packed pair interpolation it
// feeds (core/interp_packed.py::interp_mac3_packed_pair_vec, called from
// ops/flip.py::flip_update_carry). The pair pack exists only so that the
// TPU can gather 1 KB rows (pallas_pairpack.py:31-33); what the step needs
// from it is two interpolations at each particle:
//   diff = interp(du, dv, dw)   with dg = g - beta * g_old, beta = 1 - alpha
//   k1   = interp(u, v, w)
//   vel' = beta * vel + diff
// with the semantics of core/interp.py::interp_mac3, including the top-edge
// index decrements: min(floor(n), m-2) on normal axes and min(floor(e), m-1)
// on the staggered axis.
//
// Bound on the H100: device-memory bytes of the particle streams. A
// particle reads 24 B (position, velocity) and writes 24 B (vel', k1), and
// the six grids are read once: 48 MB of particle traffic and 50 MB of grids
// at 1M particles and 128^3, about 29 us at 3.35 TB/s. The sorted order the
// particles are walked in counts against the kernel, not the bound.
//
// Design: one thread a sorted slot.
//   * Thread s takes slot s of the CSR order, so the 32 lanes of a warp lie
//     in one or a few neighbouring cells, their corner loads fall on a few
//     lines, and the L1 serves their neighbours; positions and velocities,
//     already in CSR order, are read coalesced. There is no per-cell loop,
//     so a pile of thousands in one cell is only more slots.
//   * The diff grids are formed at each corner, dg = g - beta * g_old: one
//     product and one difference, the plain version's rounding under
//     -fmad=false. The kernel reads g and g_old where the step once built
//     dg in six elementwise launches, and makes as many loads.
//   * vel' and k1 go to the particle's original row, order[s], so the state
//     keeps the JAX package's particle order. That scatter is what costs:
//     the dam break's original order runs x fastest and the CSR order z
//     fastest, so a warp's 32 rows land far apart. The two outputs are the
//     halves of one (N, 6) array, so a particle's 24 B are one run, and a
//     warp writes its rows through shared memory as whole runs (PERF.md,
//     section 6: on the H100 at 128^3, 0.13 ms with six scalar stores a
//     particle, 0.056 ms so).
//   * Every slot is covered, the non-finite positions that the CSR index
//     keeps past start[ncell] included: such a particle reads in-range
//     cells and returns NaN for vel' and k1, as the plain version does.
#include "common.cuh"

namespace {

constexpr int kWarps = fst::kThreads / 32;

struct Pair {
  float diff;   // interp(g - beta * g_old)
  float value;  // interp(g)
};

// Both interpolations of one component, whose grids g and g_old have shape
// (., sy, sz).
__device__ __forceinline__ Pair trilerp_pair(const float* __restrict__ g,
                                             const float* __restrict__ g_old, float beta,
                                             int sy, int sz, fst::Split x, fst::Split y,
                                             fst::Split z) {
  const long long dx = static_cast<long long>(sy) * sz;
  const long long base = (static_cast<long long>(x.i) * sy + y.i) * sz + z.i;
  float value[8], diff[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const long long at = base + (k & 1) * dx + ((k >> 1) & 1) * sz + (k >> 2);
    value[k] = g[at];
    diff[k] = value[k] - beta * g_old[at];
  }
  return {fst::trilerp(diff, x, y, z), fst::trilerp(value, x, y, z)};
}

__global__ void __launch_bounds__(fst::kThreads)
    g2p_flip_kernel(const long long* __restrict__ order, const float* __restrict__ pcs,
                    const float* __restrict__ vels, const float* __restrict__ u,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ old_u, const float* __restrict__ old_v,
                    const float* __restrict__ old_w, float* __restrict__ rows, long long n,
                    int nx, int ny, int nz, float beta) {
  __shared__ float stage[kWarps][6 * 32];
  __shared__ long long dst[kWarps][32];
  const long long s = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  // A lane past the last slot computes slot n - 1 and stores nothing, so
  // that its warp's stores stay whole.
  const bool live = s < n;
  const long long sl = live ? s : n - 1;
  const float pi = pcs[3 * sl + 0];
  const float pj = pcs[3 * sl + 1];
  const float pk = pcs[3 * sl + 2];
  const fst::Split I = fst::split_normal(pi, nx), J = fst::split_normal(pj, ny),
                   K = fst::split_normal(pk, nz);
  const fst::Split EI = fst::split_extended(pi, nx), EJ = fst::split_extended(pj, ny),
                   EK = fst::split_extended(pk, nz);

  // U is (nx+1, ny, nz), V is (nx, ny+1, nz), W is (nx, ny, nz+1).
  const Pair U = trilerp_pair(u, old_u, beta, ny, nz, EI, J, K);
  const Pair V = trilerp_pair(v, old_v, beta, ny + 1, nz, I, EJ, K);
  const Pair W = trilerp_pair(w, old_w, beta, ny, nz + 1, I, J, EK);
  const float out[6] = {beta * vels[3 * sl + 0] + U.diff, beta * vels[3 * sl + 1] + V.diff,
                        beta * vels[3 * sl + 2] + W.diff, U.value, V.value, W.value};
  // The warp's 32 rows of 6 floats through shared memory: lane l of store j
  // writes float 32 j + l of them, so each store covers whole 24 B rows.
#pragma unroll
  for (int c = 0; c < 6; ++c) stage[wid][6 * lane + c] = out[c];
  dst[wid][lane] = live ? order[sl] : -1;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int q = 32 * j + lane, p = q / 6;
    const long long t = dst[wid][p];
    if (t >= 0) rows[6 * t + (q - 6 * p)] = stage[wid][q];
  }
}

}  // namespace

extern "C" int fst_g2p_flip(const long long* order, const float* pcs, const float* vels,
                            const float* u, const float* v, const float* w,
                            const float* old_u, const float* old_v, const float* old_w,
                            float* rows, long long n, int nx, int ny, int nz, float beta,
                            void* stream) {
  if (n > 0) {
    g2p_flip_kernel<<<fst::blocks_for(n), fst::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        order, pcs, vels, u, v, w, old_u, old_v, old_w, rows, n, nx, ny, nz, beta);
  }
  return static_cast<int>(cudaGetLastError());
}

// RK3 grid gather: the MAC grids (u, v, w) interpolated at each particle,
// core/interp.py::interp_mac3_vec in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this gather to XLA
// (fluidsimulation_tpu/ops/advect.py). It replaces the port's plain chain,
// 157 PyTorch operations over the whole particle array a call (24 index
// gathers and their elementwise splits and lerps), that
// ops/advect.py::_rk3 ran once for each RK3 stage it gathers.
//
// Semantics: those of core/interp.py::interp_mac3, through the helpers of
// common.cuh that the FLIP gather (g2p.cu) uses too: split_normal (clamp to
// [0, m-1], floor capped at m-2), split_extended (clamp c+0.5 to [0, m],
// floor capped at m-1), the lerp order of _trilerp, and the NaN rule (a NaN
// coordinate reads in-range corners and gives NaN; +-inf clamps as the
// plain version does). Compiled with -fmad=false, the result is the plain
// chain's bit for bit. nx, ny and nz come from the grids' shapes, so a
// slab's grids take the same path as a whole grid's.
//
// Bound on the H100: device-memory bytes. A particle reads its 12 B of
// position and writes its 12 B of velocity, and each face of u, v and w is
// read at least once: 24 B a particle plus 4 B a face, 1.78 GB a call at
// 256^3 with 65.5M particles (0.53 ms at 3.35 TB/s); 63 float operations a
// particle are far below the float32 rate.
//
// Design: one thread a particle, in the state's order (the dam break's
// seeding order, z outermost, then y, then x, the 8 particles of a cell
// together), so a warp's particles lie in a few neighbouring cells and
// their corner loads fall on a few lines.
//   * Reads of the positions and writes of the velocities are contiguous
//     across a warp: the warp's 32 rows of 3 floats pass through shared
//     memory, lane l of access j moving float 32 j + l of them (stride 3
//     between lanes: no bank conflict).
//   * The 24 corner loads go through the read-only path (__ldg). The two
//     z-neighbours of a corner pair are adjacent floats and usually share a
//     32 B sector.
//   * No index temporaries: the plain chain's int64 indices (8 B a particle
//     and axis) never reach device memory.
#include "common.cuh"

namespace {

constexpr int kWarps = fst::kThreads / 32;

// One component: the 8 corners of a grid shaped (., sy, sz) at cell (x.i,
// y.i, z.i), blended in core/interp.py::_trilerp's order.
__device__ __forceinline__ float trilerp_at(const float* __restrict__ g, int sy, int sz,
                                            fst::Split x, fst::Split y, fst::Split z) {
  const long long dx = static_cast<long long>(sy) * sz;
  const long long base = (static_cast<long long>(x.i) * sy + y.i) * sz + z.i;
  float c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c[k] = __ldg(g + base + (k & 1) * dx + ((k >> 1) & 1) * sz + (k >> 2));
  }
  return fst::trilerp(c, x, y, z);
}

__global__ void __launch_bounds__(fst::kThreads)
    interp_mac3_kernel(const float* __restrict__ pc, const float* __restrict__ u,
                       const float* __restrict__ v, const float* __restrict__ w,
                       float* __restrict__ out, long long n, int nx, int ny, int nz) {
  __shared__ float rows[kWarps][3 * 32];
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) + 32 * wid;
  if (first >= n) return;  // the whole warp: no particle of its own
  const int count = n - first < 32 ? static_cast<int>(n - first) : 32;

#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int q = 32 * j + lane;
    if (q < 3 * count) rows[wid][q] = pc[3 * first + q];
  }
  __syncwarp();
  // A lane past the last particle computes the warp's first and stores
  // nothing.
  const int me = lane < count ? lane : 0;
  const float pi = rows[wid][3 * me + 0];
  const float pj = rows[wid][3 * me + 1];
  const float pk = rows[wid][3 * me + 2];
  const fst::Split I = fst::split_normal(pi, nx), J = fst::split_normal(pj, ny),
                   K = fst::split_normal(pk, nz);
  const fst::Split EI = fst::split_extended(pi, nx), EJ = fst::split_extended(pj, ny),
                   EK = fst::split_extended(pk, nz);
  // U is (nx+1, ny, nz), V is (nx, ny+1, nz), W is (nx, ny, nz+1).
  const float uval = trilerp_at(u, ny, nz, EI, J, K);
  const float vval = trilerp_at(v, ny + 1, nz, I, EJ, K);
  const float wval = trilerp_at(w, ny, nz + 1, I, J, EK);
  __syncwarp();
  rows[wid][3 * lane + 0] = uval;
  rows[wid][3 * lane + 1] = vval;
  rows[wid][3 * lane + 2] = wval;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int q = 32 * j + lane;
    if (q < 3 * count) out[3 * first + q] = rows[wid][q];
  }
}

}  // namespace

extern "C" int fst_interp_mac3(const float* pc, const float* u, const float* v, const float* w,
                               float* out, long long n, int nx, int ny, int nz, void* stream) {
  if (n > 0) {
    interp_mac3_kernel<<<fst::blocks_for(n), fst::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(pc, u, v, w, out, n, nx, ny, nz);
  }
  return static_cast<int>(cudaGetLastError());
}

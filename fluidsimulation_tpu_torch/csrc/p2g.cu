// P2G accumulators over the CSR particle index: a deterministic gather.
//
// Replaces fluidsimulation_tpu/ops/pallas_p2g_super.py::
// p2g_accumulate_pallas_super (via p2g_from_super_pallas), the P2G at one
// particle per cell, and fluidsimulation_tpu/ops/pallas_p2g.py::
// p2g_accumulate_pallas (via p2g_from_table_pallas), the P2G over the
// per-cell slot table at two or more particles per cell axis. Both compute
// the same sums; the CSR walk below is exact at any occupancy. For every face
// of the U, V and W grids it sums  w * vel[a]  and  w  over the particles
// that reach the face. The weight is the trilinear hat of ops/p2g.py,
// written exactly as the scatter form computes it: per axis, with c = p + 0.5
// on the component's own axis and c = p on the others, b = floor(c) and
// al = c - b, a face f gets 1 - al when b == f, al when b == f - 1, else 0.
// The particles that can reach a face lie in the reference's cell window
// (gpTransferParticleVelocitiesU.hlsl:36-59): {f-1, f} on the component's
// axis and {f-1, f, f+1} on the other two, membership by floor(p + 0.5).
//
// Bound on the H100: particle bytes read, and load imbalance. Each face
// walks the particle lists of its 18 window cells, so each particle's 24 B
// are read by 18 faces of each of the 3 grids; L2 absorbs most of that.
// Where particles pile up (the collapsed state), a face may visit hundreds
// of particles while an air face visits none. The byte bound (each
// particle's 24 B, the CSR offsets and the six accumulators moved once, at
// 3.35 TB/s; chip_smoke.py::bound) is 25 us at 128^3 with one particle per
// cell, 9.1 us at 64^3 and 75 us at 128^3 with two per cell axis, where a
// face walks about 8x the particles it walks at one.
// Design: one thread per face, per component (blockIdx.y picks U, V or W);
// the cell order and the CSR order within a cell are fixed, so the sum is
// the same on every run. No atomics. Because cells are linearised with z
// fastest, the z-neighbours of a window are one contiguous run of CSR slots,
// so a face reads 6 runs (U, V) or 9 runs (W) of consecutive particles.
// Normalisation, boundary faces and the validity mask stay in PyTorch.
#include <algorithm>

#include "common.cuh"

namespace {

// Hat weight of one axis, in the scatter form's arithmetic.
__device__ __forceinline__ float axis_weight(float c, int f) {
  const float b = floorf(c);
  const float al = c - b;
  const float fb = static_cast<float>(f);
  if (b == fb) return 1.0f - al;
  if (b == fb - 1.0f) return al;
  return 0.0f;
}

__global__ void p2g_kernel(const float* __restrict__ pcs,
                           const float* __restrict__ vels,
                           const int* __restrict__ start,
                           float* __restrict__ acc_u, float* __restrict__ amt_u,
                           float* __restrict__ acc_v, float* __restrict__ amt_v,
                           float* __restrict__ acc_w, float* __restrict__ amt_w,
                           int nx, int ny, int nz) {
  const int a = blockIdx.y;
  const int sx = nx + (a == 0);
  const int sy = ny + (a == 1);
  const int sz = nz + (a == 2);
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<long long>(sx) * sy * sz) return;
  const int k = static_cast<int>(t % sz);
  const int j = static_cast<int>((t / sz) % sy);
  const int i = static_cast<int>(t / (static_cast<long long>(sy) * sz));

  // Window cells, clipped to the grid: f-1 .. f on the component's axis,
  // f-1 .. f+1 on the others.
  const int x0 = max(i - 1, 0), x1 = min(a == 0 ? i : i + 1, nx - 1);
  const int y0 = max(j - 1, 0), y1 = min(a == 1 ? j : j + 1, ny - 1);
  const int z0 = max(k - 1, 0), z1 = min(a == 2 ? k : k + 1, nz - 1);
  const float ox = a == 0 ? 0.5f : 0.0f;
  const float oy = a == 1 ? 0.5f : 0.0f;
  const float oz = a == 2 ? 0.5f : 0.0f;

  float acc = 0.0f, amt = 0.0f;
  for (int cx = x0; cx <= x1; ++cx) {
    for (int cy = y0; cy <= y1; ++cy) {
      // Cells (cx, cy, z0..z1) are one contiguous run of CSR slots.
      const long long row = (static_cast<long long>(cx) * ny + cy) * nz;
      const int p0 = start[row + z0];
      const int p1 = start[row + z1 + 1];
      for (int p = p0; p < p1; ++p) {
        const float* q = pcs + 3 * static_cast<long long>(p);
        const float w = axis_weight(q[0] + ox, i) * axis_weight(q[1] + oy, j) *
                        axis_weight(q[2] + oz, k);
        acc += w * vels[3 * static_cast<long long>(p) + a];
        amt += w;
      }
    }
  }
  float* acc_out = a == 0 ? acc_u : a == 1 ? acc_v : acc_w;
  float* amt_out = a == 0 ? amt_u : a == 1 ? amt_v : amt_w;
  acc_out[t] = acc;
  amt_out[t] = amt;
}

}  // namespace

extern "C" int fst_p2g(const float* pcs, const float* vels, const int* start,
                       float* acc_u, float* amt_u, float* acc_v, float* amt_v,
                       float* acc_w, float* amt_w, int nx, int ny, int nz,
                       void* stream) {
  // The largest of the three face grids: the cells plus one face layer.
  const long long cells = static_cast<long long>(nx) * ny * nz;
  const long long most =
      cells + std::max({static_cast<long long>(ny) * nz,
                        static_cast<long long>(nx) * nz,
                        static_cast<long long>(nx) * ny});
  if (nx > 0 && ny > 0 && nz > 0) {
    const dim3 grid(fst::blocks_for(most), 3);
    p2g_kernel<<<grid, fst::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        pcs, vels, start, acc_u, amt_u, acc_v, amt_v, acc_w, amt_w, nx, ny, nz);
  }
  return static_cast<int>(cudaGetLastError());
}

// The 27-neighbourhood closest-candidate pass of the level set.
//
// Replaces fluidsimulation_tpu/ops/pallas_seed.py::neighborhood_pass_pallas
// (the TPU form of ops/levelset.py::neighborhood_pass and of
// gpComputeClosestParticleNeighbors.hlsl:89-109). Each cell takes the best
// of its 27 neighbour cells' own-cell candidates: dist = |cand - cell| - r,
// updated on strict `<` in (dx, dy, dz) order, so the first winner stays.
// A neighbour outside the grid reads as the FAR candidate.
//
// Bound on the H100: device-memory bytes. A cell reads 27 candidates of
// 12 B and writes 16 B, about 30 flops of work each. The 27 re-reads of a
// candidate fall in L1/L2 (the 128^3 candidate field is 25 MB, inside the
// 50 MB L2), so DRAM sees about one read and one write per cell: 59 MB per
// call at 128^3, about 18 us at 3.35 TB/s.
// Design: one thread per cell with z fastest across a warp, so the 27
// neighbour reads of a warp are contiguous runs. No shared-memory tile in
// this first version; the L1 serves the halo.
//
// Compile with -fmad=false: a contracted multiply-add changes dist in the
// last bit, a `<` tie then picks another candidate, and cpos stops matching
// the plain version while phi still does.
#include "common.cuh"

namespace {

__global__ void neighborhood_pass_kernel(const float* __restrict__ cpos0,
                                         float* __restrict__ phi,
                                         float* __restrict__ cpos, int nx,
                                         int ny, int nz, float r) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long ncell = static_cast<long long>(nx) * ny * nz;
  if (t >= ncell) return;
  const int z = static_cast<int>(t % nz);
  const int y = static_cast<int>((t / nz) % ny);
  const int x = static_cast<int>(t / (static_cast<long long>(ny) * nz));
  const float fx = static_cast<float>(x);
  const float fy = static_cast<float>(y);
  const float fz = static_cast<float>(z);

  float best = CUDART_INF_F;
  float bx = fst::kFar, by = fst::kFar, bz = fst::kFar;
  for (int dx = -1; dx <= 1; ++dx) {
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dz = -1; dz <= 1; ++dz) {
        const int X = x + dx, Y = y + dy, Z = z + dz;
        float ax = fst::kFar, ay = fst::kFar, az = fst::kFar;
        if (X >= 0 && X < nx && Y >= 0 && Y < ny && Z >= 0 && Z < nz) {
          const float* c = cpos0 + 3 * ((static_cast<long long>(X) * ny + Y) * nz + Z);
          ax = c[0];
          ay = c[1];
          az = c[2];
        }
        const float dist = fst::dist3(ax, ay, az, fx, fy, fz) - r;
        if (dist < best) {
          best = dist;
          bx = ax;
          by = ay;
          bz = az;
        }
      }
    }
  }
  phi[t] = best;
  cpos[3 * t + 0] = bx;
  cpos[3 * t + 1] = by;
  cpos[3 * t + 2] = bz;
}

}  // namespace

extern "C" int fst_neighborhood_pass(const float* cpos0, float* phi, float* cpos,
                                     int nx, int ny, int nz, float r,
                                     void* stream) {
  const long long n = static_cast<long long>(nx) * ny * nz;
  if (n > 0) {
    neighborhood_pass_kernel<<<fst::blocks_for(n), fst::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        cpos0, phi, cpos, nx, ny, nz, r);
  }
  return static_cast<int>(cudaGetLastError());
}

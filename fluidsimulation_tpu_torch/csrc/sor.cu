// Checkerboard SOR pressure solve: the whole solve on the caller's stream.
//
// Replaces fluidsimulation_tpu/ops/pallas_sor.py::_sor_kernel (via
// sor_pressure_pallas), the TPU form of ops/project.py::sor_pressure and of
// gpProjectIteration{1,2}.hlsl. From p = 0, each iteration updates colour 0
// and then colour 1, colour = (x + y + z) % 2. A fluid cell (phi < 0) of
// the colour takes
//   nms = +0 - p[x-1] - p[x+1] - p[y-1] - p[y+1] - p[z-1] - p[z+1]
//   p   = (1 - omega) * p + (omega * (b - nms)) / diag
// where a neighbour counts only if it is inside the grid and fluid (else
// 0 is subtracted), in exactly that order, as the plain version
// (ops/cuda_sor.py::sor_pressure_plain) computes it. Compiled with
// -fmad=false and IEEE division, the kernel matches it bit for bit.
//
// Bound on the H100: the function reads phi, diag and b and writes p once,
// 16 B a cell (34 MB at 128^3, ~10 us at 3.35 TB/s), and does ~11 flops
// per fluid cell per iteration. A half-update launch moves ~4 reads of a
// half grid plus its neighbours, so the 200 launches move ~8 GB at 128^3;
// the 26 MB working set (p, b, diag, mask) fits in the 50 MB L2, so most
// of that is L2 traffic. At 64^3 the 200 launches are bound by launch
// latency, a few us each.
// Design: one half-update launch per colour, one thread per cell of that
// colour, updating p in place: every neighbour of a colour-c cell has
// colour 1-c, so a half-update reads nothing it writes, and launch order
// on one stream separates the halves. A byte mask of the cell's own and
// six neighbours' fluid flags is built once per solve. The loop of 200
// launches runs here in C, not through 200 calls from Python.
#include "common.cuh"

namespace {

// Mask bits: own fluid, then the neighbours in the order of the sum.
constexpr unsigned char kOwn = 1;
constexpr unsigned char kXm = 2, kXp = 4, kYm = 8, kYp = 16, kZm = 32, kZp = 64;

__global__ void sor_mask_kernel(const float* __restrict__ phi,
                                unsigned char* __restrict__ mask, int nx,
                                int ny, int nz) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long ncell = static_cast<long long>(nx) * ny * nz;
  if (t >= ncell) return;
  const int z = static_cast<int>(t % nz);
  const int y = static_cast<int>((t / nz) % ny);
  const int x = static_cast<int>(t / (static_cast<long long>(ny) * nz));
  const long long sx = static_cast<long long>(ny) * nz;
  const long long sy = nz;
  unsigned char m = 0;
  if (phi[t] < 0.0f) m |= kOwn;
  if (x > 0 && phi[t - sx] < 0.0f) m |= kXm;
  if (x < nx - 1 && phi[t + sx] < 0.0f) m |= kXp;
  if (y > 0 && phi[t - sy] < 0.0f) m |= kYm;
  if (y < ny - 1 && phi[t + sy] < 0.0f) m |= kYp;
  if (z > 0 && phi[t - 1] < 0.0f) m |= kZm;
  if (z < nz - 1 && phi[t + 1] < 0.0f) m |= kZp;
  mask[t] = m;
}

// One half-update: thread t takes the t-th cell of colour `color` in
// row-major order of (x, y, z/2).
__global__ void sor_half_kernel(float* __restrict__ p,
                                const float* __restrict__ b,
                                const float* __restrict__ diag,
                                const unsigned char* __restrict__ mask,
                                int nx, int ny, int nz, int color,
                                float omega, float one_minus_omega) {
  const int hz = (nz + 1) / 2;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<long long>(nx) * ny * hz) return;
  const int zh = static_cast<int>(t % hz);
  const long long row = t / hz;
  const int y = static_cast<int>(row % ny);
  const int x = static_cast<int>(row / ny);
  const int z = 2 * zh + ((x + y + color) & 1);
  if (z >= nz) return;
  const long long c = row * nz + z;
  const unsigned char m = mask[c];
  if (!(m & kOwn)) return;
  const long long sx = static_cast<long long>(ny) * nz;
  const long long sy = nz;
  float nms = 0.0f;
  nms = nms - ((m & kXm) ? p[c - sx] : 0.0f);
  nms = nms - ((m & kXp) ? p[c + sx] : 0.0f);
  nms = nms - ((m & kYm) ? p[c - sy] : 0.0f);
  nms = nms - ((m & kYp) ? p[c + sy] : 0.0f);
  nms = nms - ((m & kZm) ? p[c - 1] : 0.0f);
  nms = nms - ((m & kZp) ? p[c + 1] : 0.0f);
  p[c] = one_minus_omega * p[c] + (omega * (b[c] - nms)) / diag[c];
}

}  // namespace

extern "C" int fst_sor(const float* phi, const float* diag, const float* b,
                       float* p, unsigned char* mask, int nx, int ny, int nz,
                       int iterations, float omega, float one_minus_omega,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ncell = static_cast<long long>(nx) * ny * nz;
  if (ncell <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(p, 0, ncell * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  sor_mask_kernel<<<fst::blocks_for(ncell), fst::kThreads, 0, s>>>(phi, mask, nx, ny, nz);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long half = static_cast<long long>(nx) * ny * ((nz + 1) / 2);
  const unsigned int blocks = fst::blocks_for(half);
  for (int it = 0; it < iterations; ++it) {
    for (int color = 0; color < 2; ++color) {
      sor_half_kernel<<<blocks, fst::kThreads, 0, s>>>(
          p, b, diag, mask, nx, ny, nz, color, omega, one_minus_omega);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

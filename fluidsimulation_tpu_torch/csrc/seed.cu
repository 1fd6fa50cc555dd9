// The 27-neighbourhood closest-candidate pass of the level set.
//
// Replaces fluidsimulation_tpu/ops/pallas_seed.py::neighborhood_pass_pallas
// (the TPU form of ops/levelset.py::neighborhood_pass and of
// gpComputeClosestParticleNeighbors.hlsl:89-109). Each cell takes the best
// of its 27 neighbour cells' own-cell candidates: dist = |cand - cell| - r,
// updated on strict `<` in (dx, dy, dz) order, so the first winner stays.
// A neighbour outside the grid reads as the FAR candidate.
//
// Bound on the H100: device-memory bytes, the candidate field read once and
// phi and cpos written once: 28 B a cell, 59 MB at 128^3, about 18 us at
// 3.35 TB/s. The one-thread-a-cell form this replaced was held back by its
// issue rate: 81 scalar loads of the AoS field, a 6-way bounds test and an
// IEEE sqrt for each of the 27 candidates. Taking the sqrt only where d2
// beats the best's d2 saves little: some lane of a warp nearly always
// takes it, so the warp does (PERF.md, section 6).
//
// Design:
//   * A block owns a tile of kCX x kTY x 32 cells: its warps are kTY
//     consecutive y, its lanes 32 consecutive z, and each thread walks kCX
//     cells along x, so a warp's stores are contiguous runs. Of the tiles
//     measured on the card, 8 x 8 was the fastest at 128^3 and within 7%
//     of the best at 64^3 (PERF.md, section 6).
//   * The tile's candidates, grown by one cell on each side, are staged in
//     shared memory as the field lies: each halo row is 3 x 34 contiguous
//     floats, copied by one warp with 4 B cp.async, and FAR is written where
//     the halo leaves the grid, so the inner loop makes no bounds test. A
//     lane reads candidate h at 3h: stride 3, no bank conflicts. (Three SoA
//     planes cost more index arithmetic in the de-interleave than they
//     saved.)
//   * One sqrt a cell (pick): the 27 d2 in the plain version's order, their
//     minimum m, and the first candidate with d2 <= m (1 + 2^-12); a
//     near-tie or a candidate very close to the centre falls back to the
//     plain version's loop for that cell.
// Bit for bit the plain version, ties included. Any nx, ny, nz >= 1: a tile
// past the grid's edge is masked.
//
// Compile with -fmad=false: a contracted multiply-add changes dist in the
// last bit, a `<` tie then picks another candidate, and cpos stops matching
// the plain version while phi still does.
#include "common.cuh"

namespace {

constexpr int kTZ = 32;          // cells a tile along z: a warp's lanes
constexpr int kCX = 8, kTY = 8;  // cells a thread walks along x; warps along y
constexpr int kThreads = kTY * kTZ;
constexpr int kHY = kTY + 2, kHZ = kTZ + 2;
constexpr int kRow = 3 * kHZ;  // floats of a halo row, as the field lies
constexpr int kHalo = (kCX + 2) * kHY * kHZ;  // halo cells

// The best candidate so far: its dist and d2, and its coordinates.
struct Best {
  float dist, d2, x, y, z;
};

__device__ __forceinline__ void copy_async(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The plain version's loop over a cell's 27 candidates, hof(k) the halo
// index of candidate k = (dx, dy, dz) in row-major order; the sqrt only
// where d2 is below the best's d2 (sqrtf is correctly rounded, so d2 >=
// best_d2 gives dist >= best, which the strict `<` rejects anyway).
template <typename H>
__device__ __noinline__ Best plain_loop(const float* halo, H hof, float fx, float fy,
                                        float fz, float r) {
  Best b = {CUDART_INF_F, CUDART_INF_F, fst::kFar, fst::kFar, fst::kFar};
#pragma unroll 1
  for (int k = 0; k < 27; ++k) {
    const float* c = halo + 3 * hof(k);
    const float ex = c[0] - fx;
    const float ey = c[1] - fy;
    const float ez = c[2] - fz;
    const float d2 = ex * ex + ey * ey + ez * ez;
    if (d2 < b.d2) {
      const float dist = sqrtf(d2) - r;
      if (dist < b.dist) b = {dist, d2, c[0], c[1], c[2]};
    }
  }
  return b;
}

// The cell's winner from its 27 squared distances d2[k], k = (dx, dy, dz)
// in row-major order, hof(k) the candidate's index in the halo, with one
// sqrt: the plain version keeps the first candidate of least
// dist = fl(fl(sqrt(d2)) - r), and dist is monotone in d2, so the least
// dist is that of m = min d2, and the winner is the first candidate whose
// dist rounds to it. With m >= 1e-30 finite and sqrt(m) >= |r| / 256, no
// candidate with d2 > m (1 + 2^-12) can round to it (PERF.md, section 6), so
// the winner is the first candidate with d2 <= that threshold if its d2 is
// m. Returns false where that does not settle it (a near-tie, a candidate
// within |r| / 256 of the cell centre, no finite d2); the caller then runs
// the plain version's loop.
template <typename H>
__device__ __forceinline__ bool pick(const float (&d2)[27], H hof, float r, float& dist,
                                     int& h) {
  float m = CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 27; ++k) m = fminf(m, d2[k]);
  const float sm = sqrtf(m);
  if (!(m >= 1.0e-30f && m < CUDART_INF_F && sm * 256.0f >= fabsf(r))) return false;
  const float thresh = m + m * 2.44140625e-04f;  // m (1 + 2^-12)
  float first = CUDART_INF_F;
  h = 0;
#pragma unroll
  for (int k = 26; k >= 0; --k) {
    if (d2[k] <= thresh) {
      first = d2[k];
      h = hof(k);
    }
  }
  dist = sm - r;
  return first == m;
}

// The halo of the tile at (x0, y0, z0) into shared memory, row by row.
__device__ __forceinline__ void stage(const float* __restrict__ cpos0, float* halo, int x0,
                                      int y0, int z0, int nx, int ny, int nz) {
  constexpr int kPer = (kRow + 31) / 32;  // floats of a row a lane copies
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int zs[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) zs[j] = z0 - 1 + (lane + 32 * j) / 3;
  for (int row = warp; row < (kCX + 2) * kHY; row += kTY) {
    const int hx = row / kHY, hy = row - hx * kHY;
    const int X = x0 - 1 + hx, Y = y0 - 1 + hy;
    const bool in = X >= 0 && X < nx && Y >= 0 && Y < ny;
    const float* src = cpos0 + 3 * ((static_cast<long long>(X) * ny + Y) * nz + z0 - 1);
    float* dst = halo + row * kRow;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int f = lane + 32 * j;
      if (f < kRow) {
        if (in && zs[j] >= 0 && zs[j] < nz) {
          copy_async(dst + f, src + f);
        } else {
          dst[f] = fst::kFar;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    neighborhood_pass_kernel(const float* __restrict__ cpos0, float* __restrict__ phi,
                             float* __restrict__ cpos, int nx, int ny, int nz, float r) {
  __shared__ float halo[3 * kHalo];
  const int x0 = blockIdx.x * kCX, y0 = blockIdx.y * kTY, z0 = blockIdx.z * kTZ;
  stage(cpos0, halo, x0, y0, z0, nx, ny, nz);
  wait_copies();
  __syncthreads();

  const int ty = threadIdx.x / kTZ, tz = threadIdx.x % kTZ;
  const int y = y0 + ty, z = z0 + tz;
  if (y >= ny || z >= nz) return;
  const float fy = static_cast<float>(y), fz = static_cast<float>(z);
#pragma unroll
  for (int i = 0; i < kCX; ++i) {
    const int x = x0 + i;
    if (x >= nx) break;
    const float fx = static_cast<float>(x);
    auto hof = [=](int k) { return ((i + k / 9) * kHY + ty + (k / 3) % 3) * kHZ + tz + k % 3; };
    float d2[27];
#pragma unroll
    for (int k = 0; k < 27; ++k) {
      const float* c = halo + 3 * hof(k);
      const float ex = c[0] - fx;
      const float ey = c[1] - fy;
      const float ez = c[2] - fz;
      d2[k] = ex * ex + ey * ey + ez * ez;
    }
    Best b;
    int h;
    if (pick(d2, hof, r, b.dist, h)) {
      b.x = halo[3 * h];
      b.y = halo[3 * h + 1];
      b.z = halo[3 * h + 2];
    } else {
      b = plain_loop(halo, hof, fx, fy, fz, r);
    }
    const long long t = (static_cast<long long>(x) * ny + y) * nz + z;
    phi[t] = b.dist;
    cpos[3 * t + 0] = b.x;
    cpos[3 * t + 1] = b.y;
    cpos[3 * t + 2] = b.z;
  }
}

}  // namespace

extern "C" int fst_neighborhood_pass(const float* cpos0, float* phi, float* cpos,
                                     int nx, int ny, int nz, float r,
                                     void* stream) {
  if (static_cast<long long>(nx) * ny * nz > 0) {
    const dim3 grid((nx + kCX - 1) / kCX, (ny + kTY - 1) / kTY, (nz + kTZ - 1) / kTZ);
    neighborhood_pass_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        cpos0, phi, cpos, nx, ny, nz, r);
  }
  return static_cast<int>(cudaGetLastError());
}

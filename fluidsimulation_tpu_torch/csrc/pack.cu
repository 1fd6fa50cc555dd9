// Combined-key MAC pack: the 64-lane row table of core/interp_combined.py.
//
// Replaces fluidsimulation_tpu/core/pallas_pack.py::pack_mac3_combined_pallas,
// the TPU form of core/interp_combined.py::pack_mac3_combined. From the MAC
// grids u (nx+1, ny, nz), v (nx, ny+1, nz) and w (nx, ny, nz+1) it builds
// tab (nx*ny*(nz-1), 64): row (i, j, k) holds, in the JAX column order,
//   lanes  0-11  U at x = i+dx,   y = j-1+dy, z = k+dz  (dx 2, dy 3, dz 2)
//   lanes 12-23  V at x = i-1+dx, y = j+dy,   z = k+dz  (dx 3, dy 2, dz 2)
//   lanes 24-50  W at x = i-1+dx, y = j-1+dy, z = k+dz  (dx 3, dy 3, dz 3)
//   lanes 51-63  zero
// with dz fastest, and 0 where the JAX pack's zero halo lies (U: y outside
// [0, ny); V: x outside [0, nx); W: x or y outside). Pure copies and zeros,
// no arithmetic: the table equals the plain version
// (core/cuda_pack.py::pack_mac3_combined_plain) bit for bit. Any nx, ny >= 1
// and nz >= 2; the Pallas kernel's shifted input copies and its ny % 8 rule
// are Mosaic workarounds and are not ported.
//
// Bound on the H100: bytes. The function reads the three grids once and
// writes the table once: 25,362,432 B and 532,676,608 B at 128^3 (0.167 ms
// at 3.35 TB/s), 3,194,880 B and 66,060,288 B at 64^3 (0.0207 ms). The
// grids (25 MB at 128^3) stay in the 50 MB L2, so the write stream is the
// cost.
// Design: thread t writes the t-th 16 B of the table, lanes 4q..4q+3 of one
// row (q = t % 16), as one float4 store; a warp stores two whole rows, 512
// contiguous bytes. The lane decode comes from a 64-entry table, staged in
// shared memory so that the 16 different entries a warp reads at once are
// served together. The reads are direct, with the halo tested per lane.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kRow = 64;
constexpr int kQuads = kRow / 4;  // float4 stores a row

// Lane -> (grid: 0 U, 1 V, 2 W, 3 zero; dx, dy, dz), the JAX column order.
struct Lane {
  signed char grid, dx, dy, dz;
};
constexpr signed char kZero = 3;

__constant__ Lane kLanes[kRow] = {
    {0, 0, 0, 0}, {0, 0, 0, 1}, {0, 0, 1, 0}, {0, 0, 1, 1},  // lanes 0-3
    {0, 0, 2, 0}, {0, 0, 2, 1}, {0, 1, 0, 0}, {0, 1, 0, 1},  // lanes 4-7
    {0, 1, 1, 0}, {0, 1, 1, 1}, {0, 1, 2, 0}, {0, 1, 2, 1},  // lanes 8-11
    {1, 0, 0, 0}, {1, 0, 0, 1}, {1, 0, 1, 0}, {1, 0, 1, 1},  // lanes 12-15
    {1, 1, 0, 0}, {1, 1, 0, 1}, {1, 1, 1, 0}, {1, 1, 1, 1},  // lanes 16-19
    {1, 2, 0, 0}, {1, 2, 0, 1}, {1, 2, 1, 0}, {1, 2, 1, 1},  // lanes 20-23
    {2, 0, 0, 0}, {2, 0, 0, 1}, {2, 0, 0, 2}, {2, 0, 1, 0},  // lanes 24-27
    {2, 0, 1, 1}, {2, 0, 1, 2}, {2, 0, 2, 0}, {2, 0, 2, 1},  // lanes 28-31
    {2, 0, 2, 2}, {2, 1, 0, 0}, {2, 1, 0, 1}, {2, 1, 0, 2},  // lanes 32-35
    {2, 1, 1, 0}, {2, 1, 1, 1}, {2, 1, 1, 2}, {2, 1, 2, 0},  // lanes 36-39
    {2, 1, 2, 1}, {2, 1, 2, 2}, {2, 2, 0, 0}, {2, 2, 0, 1},  // lanes 40-43
    {2, 2, 0, 2}, {2, 2, 1, 0}, {2, 2, 1, 1}, {2, 2, 1, 2},  // lanes 44-47
    {2, 2, 2, 0}, {2, 2, 2, 1}, {2, 2, 2, 2}, {3, 0, 0, 0},  // lanes 48-51
    {3, 0, 0, 0}, {3, 0, 0, 0}, {3, 0, 0, 0}, {3, 0, 0, 0},  // lanes 52-55
    {3, 0, 0, 0}, {3, 0, 0, 0}, {3, 0, 0, 0}, {3, 0, 0, 0},  // lanes 56-59
    {3, 0, 0, 0}, {3, 0, 0, 0}, {3, 0, 0, 0}, {3, 0, 0, 0},  // lanes 60-63
};

// The value of one lane of row (i, j, k). The JAX pack pads U by one zero
// row on each side in y, V in x and W in both, so a lane's offset dx (dy)
// is one past the grid's own index on a padded axis.
__device__ __forceinline__ float lane_value(const Lane l, int i, int j, int k,
                                            const float* __restrict__ u,
                                            const float* __restrict__ v,
                                            const float* __restrict__ w,
                                            int nx, int ny, int nz) {
  if (l.grid == kZero) return 0.0f;
  const float* g;
  int sx, sy, sz, px, py;  // the grid's shape; its pads before x and y
  if (l.grid == 0) {
    g = u; sx = nx + 1; sy = ny; sz = nz; px = 0; py = 1;
  } else if (l.grid == 1) {
    g = v; sx = nx; sy = ny + 1; sz = nz; px = 1; py = 0;
  } else {
    g = w; sx = nx; sy = ny; sz = nz + 1; px = 1; py = 1;
  }
  const int x = i + l.dx - px;
  const int y = j + l.dy - py;
  if (x < 0 || x >= sx || y < 0 || y >= sy) return 0.0f;
  // z = k + dz <= nz - 2 + dz stays inside every grid's z extent.
  return g[(static_cast<long long>(x) * sy + y) * sz + (k + l.dz)];
}

__global__ void pack_mac3_combined_kernel(const float* __restrict__ u,
                                          const float* __restrict__ v,
                                          const float* __restrict__ w,
                                          float4* __restrict__ tab, int nx,
                                          int ny, int nz, long long quads) {
  __shared__ Lane lanes[kRow];
  if (threadIdx.x < kRow) lanes[threadIdx.x] = kLanes[threadIdx.x];
  __syncthreads();
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= quads) return;
  const int nzk = nz - 1;
  const unsigned int row = static_cast<unsigned int>(t / kQuads);
  const int lane0 = 4 * static_cast<int>(t % kQuads);
  const int k = static_cast<int>(row % nzk);
  const unsigned int ij = row / nzk;
  const int j = static_cast<int>(ij % ny);
  const int i = static_cast<int>(ij / ny);
  tab[t] = make_float4(lane_value(lanes[lane0], i, j, k, u, v, w, nx, ny, nz),
                       lane_value(lanes[lane0 + 1], i, j, k, u, v, w, nx, ny, nz),
                       lane_value(lanes[lane0 + 2], i, j, k, u, v, w, nx, ny, nz),
                       lane_value(lanes[lane0 + 3], i, j, k, u, v, w, nx, ny, nz));
}

}  // namespace

// tab must be 16 B aligned (a fresh PyTorch allocation is).
extern "C" int fst_pack_mac3_combined(const float* u, const float* v,
                                      const float* w, float* tab, int nx,
                                      int ny, int nz, void* stream) {
  if (nx < 1 || ny < 1 || nz < 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(nx) * ny * (nz - 1);
  if (rows > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long quads = rows * kQuads;
  pack_mac3_combined_kernel<<<fst::blocks_for(quads), fst::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      u, v, w, reinterpret_cast<float4*>(tab), nx, ny, nz, quads);
  return static_cast<int>(cudaGetLastError());
}

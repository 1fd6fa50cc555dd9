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
// with dz fastest, and +0.0 where the JAX pack's zero halo lies (U: y
// outside [0, ny); V: x outside [0, nx); W: x or y outside). Pure copies
// and zeros, no arithmetic: the table equals the plain version
// (core/cuda_pack.py::pack_mac3_combined_plain) bit for bit, NaN payloads
// and -0.0 included. Any nx, ny >= 1 and nz >= 2; the Pallas kernel's
// shifted input copies and its ny % 8 rule are Mosaic workarounds and are
// not ported.
//
// Bound on the H100: bytes. The function reads the three grids once and
// writes the table once: 25,362,432 B and 532,676,608 B at 128^3 (0.167 ms
// at 3.35 TB/s), 3,194,880 B and 66,060,288 B at 64^3 (0.0207 ms). The
// write stream is the cost; a zero-fill of the table's bytes runs near the
// bound (PERF.md, section 6).
//
// Design: a block owns a tile of rows, one x index i, kTY consecutive j and
// a chunk of up to kKC consecutive k (the whole z column up to 128^3). Its
// rows are kTY runs of kc x 256 B, each contiguous in the table.
//   1. The tile's grid windows are staged in shared memory as columns along
//      z, one warp a column, 4 B cp.async per lane (consecutive z, so each
//      copy instruction is coalesced): for each of the kTY + 2 y-slots
//      (y = j0-1 .. j0+kTY) eight x-planes, U at x = i, i+1, V at i-1..i+1
//      and W at i-1..i+1. A column outside its grid is written as +0.0, so
//      the halo is tested once a column, not once a lane.
//   2. Every thread stores the same four lanes of each row it writes
//      (lanes 4q..4q+3, q = thread % 16), so it decodes their shared-memory
//      offsets once. Lane l of row (j0+jj, k0+kk) lies at
//      off[l] + jj * step[l] + kk: step is the y-slot stride for a data lane
//      and 0 for a zero lane, which reads a run of +0.0. The row loop is
//      four shared-memory loads and one float4 store: no division, no
//      branch on the grid or the halo.
//   3. A warp stores two whole rows, 512 contiguous bytes, with st.global.cs
//      (evict-first), so the 533 MB table stream does not push the grids
//      out of L2.
// The column stride is the chunk's length + 2 rounded up to 3 mod 32, the
// y-slot stride 8 columns + 9 floats: a warp's loads (16 lanes' offsets at
// two consecutive k) then take 2 shared-memory wavefronts, against 3.5
// without the padding. At 128^3 a block stages 42.8 KB, so five blocks
// share an SM and one block's staging overlaps the others' stores.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kRow = 64;
constexpr int kQuads = kRow / 4;  // float4 stores a row
constexpr int kThreads = 256;
constexpr int kRowsAPass = kThreads / kQuads;
constexpr int kPlanes = 8;  // x-planes a y-slot: U i, i+1; V i-1..i+1; W i-1..i+1
// Rows of a tile along y, and along z at most. Of the tiles measured on the
// card (4, 8 and 16 along y; 64 and 128 along z) none was more than 5%
// faster than 8 x 128 at 128^3 and 64^3 (PERF.md, section 6).
constexpr int kTY = 8, kKC = 128;

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

// Shared-memory layout of a tile, in floats: column stride zs, y-slot
// stride ss, and the offset of the zero run after the kTY + 2 slots.
struct Layout {
  int zs, ss, zero;
};

constexpr Layout layout(int kcmax) {
  const int zs = kcmax + 2 + ((3 - (kcmax + 2)) & 31);  // zs = 3 (mod 32)
  const int ss = kPlanes * zs + 9;
  return {zs, ss, (kTY + 2) * ss};
}

// The slots and the zero run fit the 48 KB a launch gets without opting in.
static_assert(4 * (layout(kKC).zero + kKC) <= 48 * 1024, "tile's shared memory");

__device__ __forceinline__ void copy_async(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    pack_mac3_combined_kernel(const float* __restrict__ u, const float* __restrict__ v,
                              const float* __restrict__ w, float4* __restrict__ tab, int nx,
                              int ny, int nz, unsigned int nkc, unsigned int njt, Layout lay) {
  extern __shared__ float stage[];
  const int nzk = nz - 1;
  const unsigned int t = blockIdx.x / nkc;
  const int k0 = static_cast<int>(blockIdx.x - t * nkc) * kKC;
  const int j0 = static_cast<int>(t % njt) * kTY;
  const int i = static_cast<int>(t / njt);
  const int kc = min(kKC, nzk - k0);
  const int jv = min(kTY, ny - j0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. The windows: column c is y-slot c / 8 (y = j0 - 1 + slot), x-plane
  //    c % 8. U and V columns hold z = k0 .. k0+kc, W columns one more.
  for (int c = warp; c < (kTY + 2) * kPlanes; c += kThreads / 32) {
    const int s = c >> 3, p = c & 7;
    const int y = j0 - 1 + s;
    float* dst = stage + s * lay.ss + p * lay.zs;
    const float* src = nullptr;
    int len = kc + 1;
    if (p < 2) {  // U at x = i + p
      if (y >= 0 && y < ny) src = u + (static_cast<long long>(i + p) * ny + y) * nz;
    } else if (p < 5) {  // V at x = i + p - 3
      const int x = i + p - 3;
      if (x >= 0 && x < nx && y >= 0 && y <= ny)
        src = v + (static_cast<long long>(x) * (ny + 1) + y) * nz;
    } else {  // W at x = i + p - 6
      const int x = i + p - 6;
      len = kc + 2;
      if (x >= 0 && x < nx && y >= 0 && y < ny)
        src = w + (static_cast<long long>(x) * ny + y) * (nz + 1);
    }
    if (src != nullptr) {
      src += k0;
      for (int z = lane; z < len; z += 32) copy_async(dst + z, src + z);
    } else {
      for (int z = lane; z < len; z += 32) dst[z] = 0.0f;
    }
  }
  for (int z = threadIdx.x; z < kc; z += kThreads) stage[lay.zero + z] = 0.0f;
  wait_copies();
  __syncthreads();

  // 2. This thread's four lanes: their offsets and y-slot steps.
  const int q = threadIdx.x % kQuads;
  int off[4], step[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Lane l = kLanes[4 * q + e];
    if (l.grid == kZero) {
      off[e] = lay.zero;
      step[e] = 0;
    } else {
      const int slot = l.dy + (l.grid == 1);
      const int plane = l.dx + (l.grid == 0 ? 0 : l.grid == 1 ? 2 : 5);
      off[e] = slot * lay.ss + plane * lay.zs + l.dz;
      step[e] = lay.ss;
    }
  }

  // 3. The rows: y-slot run jj, then a pass of 16 rows along k at a time.
  const int r0 = threadIdx.x / kQuads;
  for (int jj = 0; jj < jv; ++jj) {
    const float* s0 = stage + off[0] + jj * step[0];
    const float* s1 = stage + off[1] + jj * step[1];
    const float* s2 = stage + off[2] + jj * step[2];
    const float* s3 = stage + off[3] + jj * step[3];
    float4* out = tab + (static_cast<long long>(i * ny + j0 + jj) * nzk + k0) * kQuads + q;
    for (int kk = r0; kk < kc; kk += kRowsAPass) {
      __stcs(out + kk * kQuads, make_float4(s0[kk], s1[kk], s2[kk], s3[kk]));
    }
  }
}

}  // namespace

// tab must be 16 B aligned (a fresh PyTorch allocation is).
extern "C" int fst_pack_mac3_combined(const float* u, const float* v,
                                      const float* w, float* tab, int nx,
                                      int ny, int nz, void* stream) {
  if (nx < 1 || ny < 1 || nz < 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(nx) * ny * (nz - 1);
  if (rows > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int nzk = nz - 1;
  const int kcmax = std::min(kKC, nzk);
  const Layout lay = layout(kcmax);
  const size_t smem = static_cast<size_t>(lay.zero + kcmax) * sizeof(float);
  const unsigned int nkc = (nzk + kKC - 1) / kKC, njt = (ny + kTY - 1) / kTY;
  const long long blocks = static_cast<long long>(nx) * njt * nkc;
  pack_mac3_combined_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      u, v, w, reinterpret_cast<float4*>(tab), nx, ny, nz, nkc, njt, lay);
  return static_cast<int>(cudaGetLastError());
}

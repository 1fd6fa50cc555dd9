// P2G accumulators over the CSR particle index: a deterministic gather by
// cell tiles, the particles staged through shared memory.
//
// Replaces fluidsimulation_tpu/ops/pallas_p2g_super.py::
// p2g_accumulate_pallas_super (via p2g_from_super_pallas), the P2G at one
// particle per cell, and fluidsimulation_tpu/ops/pallas_p2g.py::
// p2g_accumulate_pallas (via p2g_from_table_pallas), the P2G over the
// per-cell slot table at two or more particles per cell axis. Both compute
// the same sums, and so does this kernel at any occupancy. For every face
// of the U, V and W grids it sums  w * vel[a]  and  w  over the particles
// that reach the face. The weight is the trilinear hat of ops/p2g.py,
// written exactly as the scatter form computes it: per axis, with c = p + 0.5
// on the component's own axis and c = p on the others, b = floor(c) and
// al = c - b, a face f gets 1 - al when b == f, al when b == f - 1, else 0;
// w is the product of the x, y and z factors in that order. The particles
// that can reach a face lie in the reference's cell window
// (gpTransferParticleVelocitiesU.hlsl:36-59): {f-1, f} on the component's
// axis and {f-1, f, f+1} on the other two, membership by floor(p + 0.5).
//
// Bound on the H100: each particle's 24 B, the CSR offsets and the six
// accumulators moved once (25 us at 128^3 with one particle per cell, 9.1 us
// at 64^3 and 75 us at 128^3 with two per cell axis, at 3.35 TB/s;
// bench_torch/harness/roofline.py). What holds the gather back is not bytes
// but the walk: every particle is visited by the threads of the 27 cells
// around it, each visit a chain of shared loads, hats, products and sums, and
// a warp steps as often as its busiest lane. Particles pile up at the walls (the
// advection clamp puts them on the boundary planes: 159 in one cell at 128^3
// ppc 1 after 20 steps, 3,320 in the demo after 60), so lanes next to a pile
// walk hundreds or thousands of particles while their neighbours idle
// (PERF.md, section 6).
//
// Design, the TPU kernels' cell-indexed form (ops/pallas_p2g.py:1-22):
//   * A block owns a tile of 1 x 8 x 32 cells, z fastest, one thread a
//     cell, so a warp is 32 consecutive z. The thread of cell (i, j, k)
//     produces the U, V and W faces with that index; a thread on the grid's
//     upper edge also the last face layer (index nx, ny or nz). Of the
//     tiles measured on the card (1 x 8, 2 x 8, 1 x 4 in x, y), 1 x 8 was
//     within 5% of the best at all three paths (PERF.md, section 6).
//   * The halo, the tile grown by one cell on each side, is staged in shared
//     memory. Cells are linearised with z fastest (ops/binning.py), so each
//     (cx, cy) column of the halo is one contiguous run of CSR slots. The
//     block copies the runs coalesced with 4 B cp.async (any alignment) into
//     six arrays x, y, z, vx, vy, vz, at halo positions: column after
//     column, in (cx, cy) order. The offsets of the halo's cells are kept
//     in shared memory too, local to the tile.
//   * Where the halo holds more than kChunk particles (piles of hundreds or
//     thousands a cell), it is walked in chunks of kChunk halo positions,
//     double-buffered: the copies of chunk t + 1 fly while chunk t is
//     walked. Each thread carries its accumulators in registers from chunk
//     to chunk, so shared memory does not grow with the pile or the grid.
//   * One walk serves the three components: a thread walks the union of its
//     three windows, the 3 x 3 x 3 cells around it, column by column, each
//     column's cells k-1 .. k+1 as one run, and adds to U, V and W. The
//     column loop is unrolled, so the column's offset (dx, dy) is a
//     constant: U is skipped in the columns dx = 2, V in dy = 2 (the hat of
//     the own axis is 0 there), and the x and y hats need no search (see
//     plain_hat).
// The same sums in the same order as the face-per-thread kernel this one
// replaced: particles reach a face in the order cx, then cy, then the CSR run
// along z, then slot, in chunks that follow that order. The union adds only
// particles whose weight for the face is exactly 0 (their cell lies outside
// the face's window, so the hat of that axis is 0), and adding +-0 to a sum
// changes no bit. Compiled with -fmad=false and no atomics, the result is
// therefore bit for bit that kernel's, and the same on every run.
// Any nx, ny, nz >= 1: ragged tiles are masked. A particle the CSR index
// keeps past start[ncell] (a non-finite position) lies in no run and is
// never read.
// Shared memory a block: 2 buffers x 6 arrays x kField floats (a 32-slot
// row padded by one float, fields 11 banks apart) plus the halo's offsets:
// 106,224 B a block, two blocks an SM.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTZ = 32;        // cells a tile along z: one warp
constexpr int kChunk = 2048;   // halo positions a buffer holds
// One float of padding after every 32 slots spreads the slots that lanes
// walking different cells read (8 apart at two particles a cell axis) over
// the banks; fields then lie 11 banks apart.
constexpr int kField = kChunk + kChunk / 32 + 11;
constexpr int kBuffer = 6 * kField;

constexpr int kTX = 1, kTY = 8;  // cells a tile along x and y
constexpr int kThreads = kTX * kTY * kTZ;
constexpr int kWarps = kThreads / 32;
constexpr int kHY = kTY + 2;
constexpr int kCols = (kTX + 2) * (kTY + 2);  // halo columns
constexpr int kZ = kTZ + 3;  // offsets of halo cells z0-1 .. z0+32, and the end
constexpr int kSmem = 4 * (2 * kBuffer + kCols * kZ + kCols);
static_assert(kCols <= 64, "the column scan covers two warp widths");

__device__ __forceinline__ int slot(int q) { return q + (q >> 5); }

__device__ __forceinline__ void copy_async(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int inclusive_scan(int v, int lane) {
  for (int d = 1; d < 32; d *= 2) {
    const int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// The sums of one thread: its U, V and W faces, and the last face layer
// where the thread lies on the grid's upper edge.
struct Sums {
  float au = 0.0f, mu = 0.0f, av = 0.0f, mv = 0.0f, aw = 0.0f, mw = 0.0f;
  float au1 = 0.0f, mu1 = 0.0f, av1 = 0.0f, mv1 = 0.0f, aw1 = 0.0f, mw1 = 0.0f;
};

// Hat weight of one axis at face fb, in the scatter form's arithmetic.
__device__ __forceinline__ float hat(float c, float fb) {
  const float b = floorf(c);
  const float al = c - b;
  if (b == fb) return 1.0f - al;
  if (b == fb - 1.0f) return al;
  return 0.0f;
}

// The thread's face index f along one axis, and the particle's cell
// f - 1 + D (D = 0, 1, 2) along it: the particles of a CSR run satisfy
// floor(p + 0.5) == cell (ops/binning.py builds the runs from these same
// values), so floor(p) is cell - 1 or cell. The hats of ops/p2g.py, as hat()
// computes them, then need no search:
//   plain (c = p):        b = floor(p), al = p - b; D = 0: b == cell ? al : 0;
//                         D = 1: b == cell ? 1 - al : al; D = 2: b == cell ? 0 : 1 - al;
//   half-shifted (c = p + 0.5): b = cell, al = c - cell; D = 0: al; D = 1: 1 - al;
//                         D = 2: 0; and at face f + 1 (the last face layer): D = 1: al.
template <int D>
__device__ __forceinline__ float plain_hat(float p, float cell) {
  const float b = floorf(p);
  const float al = p - b;
  if (D == 0) return b == cell ? al : 0.0f;
  if (D == 1) return b == cell ? 1.0f - al : al;
  return b == cell ? 0.0f : 1.0f - al;
}

// Walk the buffer positions [lo, hi): the particles of cells k-1 .. k+1 of
// column (i - 1 + DX, j - 1 + DY), whose x and y cells are cx and cy. Along
// z the particle's cell varies within the run, so the z hats are hat()'s.
// Unrolled by two, so that the loads and hats of one particle overlap the
// sums of the one before; the sums keep their order.
template <int DX, int DY>
__device__ __forceinline__ void walk_run(const float* __restrict__ buf, int lo, int hi, int c0,
                                         float cx, float cy, float fk, bool ex, bool ey,
                                         bool ez, Sums& s) {
#pragma unroll 2
  for (int h = lo; h < hi; ++h) {
    const int at = slot(h - c0);
    const float x = buf[at], y = buf[kField + at], z = buf[2 * kField + at];
    const float wxp = plain_hat<DX>(x, cx);
    const float wyp = plain_hat<DY>(y, cy);
    const float wzp = hat(z, fk);
    const float zs = z + 0.5f;
    if (DX < 2) {
      const float sx = (x + 0.5f) - cx;
      const float wxs = DX == 1 ? 1.0f - sx : sx;
      const float vx = buf[3 * kField + at];
      const float wu = wxs * wyp * wzp;
      s.au += wu * vx;
      s.mu += wu;
      if (DX == 1 && ex) {
        const float w1 = sx * wyp * wzp;
        s.au1 += w1 * vx;
        s.mu1 += w1;
      }
    }
    if (DY < 2) {
      const float sy = (y + 0.5f) - cy;
      const float wys = DY == 1 ? 1.0f - sy : sy;
      const float vy = buf[4 * kField + at];
      const float wv = wxp * wys * wzp;
      s.av += wv * vy;
      s.mv += wv;
      if (DY == 1 && ey) {
        const float w1 = wxp * sy * wzp;
        s.av1 += w1 * vy;
        s.mv1 += w1;
      }
    }
    {
      const float vz = buf[5 * kField + at];
      const float ww = wxp * wyp * hat(zs, fk);
      s.aw += ww * vz;
      s.mw += ww;
      if (ez) {
        const float w1 = wxp * wyp * hat(zs, fk + 1.0f);
        s.aw1 += w1 * vz;
        s.mw1 += w1;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
p2g_tile_kernel(const float* __restrict__ pcs, const float* __restrict__ vels,
                const int* __restrict__ start, float* __restrict__ acc_u,
                float* __restrict__ amt_u, float* __restrict__ acc_v,
                float* __restrict__ amt_v, float* __restrict__ acc_w,
                float* __restrict__ amt_w, int nx, int ny, int nz, int xo) {
  extern __shared__ float smem[];
  float* buffers = smem;  // [2][x, y, z, vx, vy, vz][kField]
  // first[c * kZ + zl]: global CSR slot of halo cell zl (z = z0 - 1 + zl,
  // clamped to [0, nz]) of column c; 0 for a column off the grid.
  int* first = reinterpret_cast<int*>(smem + 2 * kBuffer);
  // shift[c]: halo position minus global slot, within column c.
  int* shift = first + kCols * kZ;
  __shared__ int total;  // particles in the halo

  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY, z0 = blockIdx.z * kTZ;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lk = tid % kTZ, lj = (tid / kTZ) % kTY, li = tid / (kTZ * kTY);
  const int i = x0 + li, j = y0 + lj, k = z0 + lk;

  for (int e = tid; e < kCols * kZ; e += kThreads) {
    const int c = e / kZ, zl = e % kZ;
    const int cx = x0 - 1 + c / kHY, cy = y0 - 1 + c % kHY;
    int s = 0;
    if (cx >= 0 && cx < nx && cy >= 0 && cy < ny) {
      const int z = min(max(z0 - 1 + zl, 0), nz);
      s = start[(static_cast<long long>(cx) * ny + cy) * nz + z];
    }
    first[e] = s;
  }
  __syncthreads();
  if (warp == 0) {
    // Halo positions: a column's particles follow those of the columns
    // before it.
    auto count = [&](int c) {
      return c < kCols ? first[c * kZ + kZ - 1] - first[c * kZ] : 0;
    };
    const int na = count(lane), nb = count(lane + 32);
    const int a = inclusive_scan(na, lane), b = inclusive_scan(nb, lane);
    const int sum_a = __shfl_sync(0xffffffffu, a, 31);
    if (lane < kCols) shift[lane] = a - na - first[lane * kZ];
    if (lane + 32 < kCols) shift[lane + 32] = sum_a + b - nb - first[(lane + 32) * kZ];
    if (lane == 31) total = sum_a + b;
  }
  __syncthreads();
  const int chunks = (total + kChunk - 1) / kChunk;

  // Copy halo positions [t * kChunk, ...) into buffer t % 2: warp w takes
  // every kWarps-th column, its lanes the column's floats in order.
  auto load = [&](int t) {
    const int c0 = t * kChunk, c1 = min(c0 + kChunk, total);
    float* buf = buffers + (t & 1) * kBuffer;
    for (int c = warp; c < kCols; c += kWarps) {
      const int g0 = first[c * kZ];
      const int h0 = g0 + shift[c], h1 = first[c * kZ + kZ - 1] + shift[c];
      const int lo = max(h0, c0), hi = min(h1, c1);
      const long long g = static_cast<long long>(g0) + (lo - h0);
      for (int e = lane; e < 3 * (hi - lo); e += 32) {
        const int at = (e % 3) * kField + slot(lo - c0 + e / 3);
        copy_async(buf + at, pcs + 3 * g + e);
        copy_async(buf + 3 * kField + at, vels + 3 * g + e);
      }
    }
    commit_copies();
  };

  const bool active = i < nx && j < ny && k < nz;
  const bool ex = i == nx - 1, ey = j == ny - 1, ez = k == nz - 1;
  // The particles' x is in the frame of the domain, whose plane xo is the
  // grid's plane 0 (a rank's extended slab; 0 for a whole grid).
  const float fi = static_cast<float>(i + xo), fj = static_cast<float>(j), fk = static_cast<float>(k);
  Sums s;

  if (chunks > 0) load(0);
  for (int t = 0; t < chunks; ++t) {
    if (t + 1 < chunks) {
      load(t + 1);
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    if (active) {
      const int c0 = t * kChunk, c1 = min(c0 + kChunk, total);
      const float* buf = buffers + (t & 1) * kBuffer;
      // The 27 cells around (i, j, k) in the order cx, cy, cz: column
      // (i-1+dx, j-1+dy), then its cells k-1 .. k+1, one CSR run.
      auto column = [&](auto dx, auto dy) {
        constexpr int DX = decltype(dx)::value, DY = decltype(dy)::value;
        const int c = (li + DX) * kHY + lj + DY;
        const int* f = first + c * kZ + lk;
        const int sh = shift[c];
        const int h0 = f[0] + sh, h3 = f[3] + sh;
        const float cx = fi + (DX - 1.0f), cy = fj + (DY - 1.0f);
        walk_run<DX, DY>(buf, max(h0, c0), min(h3, c1), c0, cx, cy, fk, ex, ey, ez, s);
      };
      using Z = std::integral_constant<int, 0>;
      using O = std::integral_constant<int, 1>;
      using W = std::integral_constant<int, 2>;
      column(Z(), Z()), column(Z(), O()), column(Z(), W());
      column(O(), Z()), column(O(), O()), column(O(), W());
      column(W(), Z()), column(W(), O()), column(W(), W());
    }
    __syncthreads();
  }

  if (!active) return;
  // U is (nx+1, ny, nz), V (nx, ny+1, nz), W (nx, ny, nz+1).
  const long long u = (static_cast<long long>(i) * ny + j) * nz + k;
  const long long v = (static_cast<long long>(i) * (ny + 1) + j) * nz + k;
  const long long w = (static_cast<long long>(i) * ny + j) * (nz + 1) + k;
  acc_u[u] = s.au;
  amt_u[u] = s.mu;
  acc_v[v] = s.av;
  amt_v[v] = s.mv;
  acc_w[w] = s.aw;
  amt_w[w] = s.mw;
  if (ex) {
    const long long u1 = u + static_cast<long long>(ny) * nz;
    acc_u[u1] = s.au1;
    amt_u[u1] = s.mu1;
  }
  if (ey) {
    acc_v[v + nz] = s.av1;
    amt_v[v + nz] = s.mv1;
  }
  if (ez) {
    acc_w[w + 1] = s.aw1;
    amt_w[w + 1] = s.mw1;
  }
}

}  // namespace

// x0: the grid's plane 0 is plane x0 of the domain, in whose cell units pcs
// are (a rank's extended slab in parallel/halo_step.py): the CSR runs are
// the grid's cells, floor(p + 0.5) - x0 along x. 0 for a whole grid.
extern "C" int fst_p2g(const float* pcs, const float* vels, const int* start,
                       float* acc_u, float* amt_u, float* acc_v, float* amt_v,
                       float* acc_w, float* amt_w, int nx, int ny, int nz, int x0,
                       void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t err = cudaFuncSetAttribute(
      p2g_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY, (nz + kTZ - 1) / kTZ);
  p2g_tile_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      pcs, vels, start, acc_u, amt_u, acc_v, amt_v, acc_w, amt_w, nx, ny, nz, x0);
  return static_cast<int>(cudaGetLastError());
}

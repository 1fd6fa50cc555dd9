// APIC P2G over the CSR particle index: a deterministic gather by cell
// tiles, the particles staged through shared memory, with the plain form's
// division, validity test and boundary faces fused in.
//
// Replaces no TPU kernel: the JAX package computes the APIC P2G with XLA's
// scatter (fluidsimulation_tpu/ops/apic.py::p2g_apic), and so does the plain
// form here (ops/apic.py::p2g_apic_cells: one index_add_ a spline node and
// an accumulator, 162 on the card, which add by atomics in no fixed order).
// For every face of the U, V and W grids it sums  w * (vel[a] + C[a,:] .
// (x_face - x_p))  and  w  over the particles that reach the face, each
// term formed as the plain form forms it (ops/apic.py::_axis_nodes,
// _component_nodes): per axis, with t = p + 0.5 on the component's own axis
// and t = p + 0 on the others, base = floor(t - 0.5) (NaN: node 0), the face
// f is one of the particle's nodes if base <= f <= base + 2; then d = t - f,
// the quadratic B-spline of d, the lever -d / m (m = cells a metre along the
// axis); w = (w_x * w_y) * w_z; the value ((vel + c0 lx) + c1 ly) + c2 lz.
// A face's mean is acc / max(amt, 1e-30), valid where amt > thresh; the
// faces at index 0 and n of their own axis are 0 and valid.
//
// Bound on the H100: each particle's 60 B (position, velocity, C), the CSR
// offsets and the three grids with their validity moved once (0.16 ms at
// 128^3 with two particles a cell axis, at 3.35 TB/s; PERF.md, section
// 6). As in p2g.cu, what holds it back is the walk: every particle is
// visited by the threads of the 4 x 4 x 4 cells around it (less the column
// and cells no face of theirs can reach), each visit up to six spline
// nodes and three affine terms, and a warp steps as often as its busiest
// lane. APIC's velocities pack particles into dense cells, at the walls and
// inside the fluid: at 128^3 with two particles a cell axis, after 60 to
// 420 steps of the dam break, 3,000-4,400 cells hold over 64 particles each
// and the densest 4,800-23,000 (PERF.md, section 6).
//
// Design (p2g.cu's, for the spline's wider window):
//   * A block owns a tile of 1 x 8 x 32 cells, z fastest, one thread a
//     cell. The thread of cell (i, j, k) produces the U, V and W faces with
//     that index; a thread on the grid's upper edge also the last face layer
//     (index nx, ny or nz), a boundary face.
//   * Membership of the CSR runs is by floor(p + 0.5). The particles that
//     can reach face f lie in cells f-2 .. f+1 along the component's own
//     axis and f-1 .. f+1 along the other two, so the halo is the tile grown
//     by 2 cells below and 1 above on each axis, and one walk over the
//     union of the three windows serves the three components. Of the 4 x 4
//     columns (i-2+dx, j-2+dy) the thread walks, (0, 0) reaches no face of
//     it, dx = 0 only U, dy = 0 only V; along z, cell k-2 only W.
//   * Each (cx, cy) column of the halo is one contiguous run of CSR slots;
//     the block copies the runs coalesced with 4 B cp.async into fifteen
//     arrays (x, y, z, vx, vy, vz, C row by row) at halo positions, column
//     after column, in chunks of kChunk positions, double-buffered: the
//     copies of chunk t + 1 fly while chunk t is walked, so piles of
//     thousands of particles cost no more shared memory.
//   * A warp is 32 cells of one z-line, so its lanes walk the same column,
//     each its own run of cells along z. Where one lane's run is long (64
//     positions or more in the chunk: a dense cell; a run of three cells
//     holds 24 at two particles a cell axis), the warp shares the runs out
//     in pieces of kPiece positions (walk_part), so that it steps as the
//     pieces need and not as the dense cell's 4 lanes would alone.
//   * The particles the CSR index keeps past start[ncell] (a non-finite or
//     out-of-grid coordinate) are read from device memory by every thread,
//     after the runs, and held to the same node rule: a NaN coordinate has
//     node 0 on its axis, weight 0 and a NaN lever, so it leaves the faces
//     of nodes 0 .. 2 non-finite, as the plain form does.
//   * Where m is a power of two on every axis, -d / m is -d * (1 / m), the
//     same bits; other grids divide.
// A face sums its terms in the order column (dx, then dy), run, slot, then
// the tail: the CSR order. Where a warp shares its runs, each piece is summed
// from zero and the pieces' sums are added to the face's in that order.
// Compiled with -fmad=false and no atomics, the result is the same bits on
// every run; it differs from the plain form only by summation order.
// Any nx, ny, nz >= 1: ragged tiles are masked. The finite positions must lie
// in the grid's cells (floor(p + 0.5) in [0, n) on each axis), as advection
// keeps them.
// Shared memory a block: 2 buffers x 15 arrays x kField floats, the halo's
// offsets and each warp's piece sums: 93,176 B a block, two blocks an SM.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTZ = 32;       // cells a tile along z: one warp
constexpr int kTX = 1, kTY = 8;
constexpr int kThreads = kTX * kTY * kTZ;
constexpr int kWarps = kThreads / 32;
constexpr int kBelow = 2, kAbove = 1;  // halo cells below and above the tile
constexpr int kHX = kTX + kBelow + kAbove, kHY = kTY + kBelow + kAbove;
constexpr int kCols = kHX * kHY;         // halo columns
constexpr int kWin = kBelow + 1 + kAbove;  // the cells a thread walks along each axis
constexpr int kZ = kTZ + kBelow + kAbove + 1;  // offsets of cells z0-2 .. z0+32, and the end
constexpr int kChunk = 640;  // halo positions a buffer holds
// One float of padding after every 32 slots spreads the slots that lanes
// walking different cells read over the banks.
constexpr int kField = kChunk + kChunk / 32 + 11;
constexpr int kFields = 15;  // x, y, z, vx, vy, vz, C[0][0..2], C[1][0..2], C[2][0..2]
constexpr int kBuffer = kFields * kField;
constexpr int kPiece = 16;    // positions a piece of a shared run
constexpr int kScratch = 32 * 6;  // a warp's piece sums: 6 floats a lane
constexpr int kSmem = 4 * (2 * kBuffer + kCols * kZ + kCols + kWarps * kScratch);
static_assert(kCols <= 64, "the column scan covers two warp widths");

constexpr int kU = 1, kV = 2, kW = 4;
constexpr unsigned kAll = 0xffffffffu;

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

// The thread's faces and the grid's scale: face index f and m, 1 / m a
// metre of each axis.
struct Faces {
  float f[3], m[3], r[3];
};

struct Sums {
  float au = 0.0f, mu = 0.0f, av = 0.0f, mv = 0.0f, aw = 0.0f, mw = 0.0f;
};

// One axis of a particle at coordinate t (node frame) against face f:
// whether f is one of its three nodes, the spline weight and d = t - f.
struct Node {
  bool in;
  float w, d;
};

// ops/apic.py::_quad_spline.
__device__ __forceinline__ float spline(float d) {
  const float ad = fabsf(d);
  const float inner = 0.75f - ad * ad;
  const float o = 1.5f - ad;
  const float outer = 0.5f * (o * o);
  return ad < 0.5f ? inner : (ad < 1.5f ? outer : 0.0f);
}

__device__ __forceinline__ Node node(float t, float f) {
  float b = floorf(t - 0.5f);
  if (b != b) b = 0.0f;  // index_of: floor(NaN) is node 0
  const float d = t - f;
  return {b <= f && f <= b + 2.0f, spline(d), d};
}

// The lever x_face - x_p in metres, -d / m.
template <bool POW2>
__device__ __forceinline__ float lever(float d, const Faces& g, int ax) {
  return POW2 ? -d * g.r[ax] : -d / g.m[ax];
}

__device__ __forceinline__ void add(float& acc, float& amt, float w, float v, float c0,
                                    float c1, float c2, float lx, float ly, float lz) {
  const float val = ((v + c0 * lx) + c1 * ly) + c2 * lz;
  acc += w * val;
  amt += w;
}

// The terms of one particle in the components of MASK. get(q) reads field
// q of the particle (kFields' order).
template <int MASK, bool POW2, class Get>
__device__ __forceinline__ void visit(const Get& get, const Faces& g, Sums& s) {
  const float x = get(0), y = get(1), z = get(2);
  Node xp{}, yp{}, zp{};
  if (MASK & (kV | kW)) xp = node(x + 0.0f, g.f[0]);
  if (MASK & (kU | kW)) yp = node(y + 0.0f, g.f[1]);
  if (MASK & (kU | kV)) zp = node(z + 0.0f, g.f[2]);
  if (MASK & kU) {
    const Node xs = node(x + 0.5f, g.f[0]);
    if (xs.in && yp.in && zp.in) {
      add(s.au, s.mu, (xs.w * yp.w) * zp.w, get(3), get(6), get(7), get(8),
          lever<POW2>(xs.d, g, 0), lever<POW2>(yp.d, g, 1), lever<POW2>(zp.d, g, 2));
    }
  }
  if (MASK & kV) {
    const Node ys = node(y + 0.5f, g.f[1]);
    if (xp.in && ys.in && zp.in) {
      add(s.av, s.mv, (xp.w * ys.w) * zp.w, get(4), get(9), get(10), get(11),
          lever<POW2>(xp.d, g, 0), lever<POW2>(ys.d, g, 1), lever<POW2>(zp.d, g, 2));
    }
  }
  if (MASK & kW) {
    const Node zs = node(z + 0.5f, g.f[2]);
    if (xp.in && yp.in && zs.in) {
      add(s.aw, s.mw, (xp.w * yp.w) * zs.w, get(5), get(12), get(13), get(14),
          lever<POW2>(xp.d, g, 0), lever<POW2>(yp.d, g, 1), lever<POW2>(zs.d, g, 2));
    }
  }
}

// Walk the buffer positions [lo, hi) for the components of MASK. Unrolled
// by two, so that one particle's loads and nodes overlap the sums of the
// one before; the sums keep their order.
template <int MASK, bool POW2>
__device__ __forceinline__ void walk(const float* __restrict__ buf, int lo, int hi, int c0,
                                     const Faces& g, Sums& s) {
#pragma unroll 2
  for (int h = lo; h < hi; ++h) {
    const float* p = buf + slot(h - c0);
    visit<MASK, POW2>([p](int q) { return p[q * kField]; }, g, s);
  }
}

// One column part of a warp's walk: [lo, hi) the run of each lane (empty
// past the grid). Where the runs are even, each lane walks its own. Where
// one is long (4 pieces or more: a dense cell, where thousands of particles
// can pile up), the lanes share them: every run is cut into pieces of kPiece positions, the
// pieces of all runs, in lane order, are dealt to the lanes 32 at a time,
// each summed from zero for the faces of the lane whose run it is, and each
// lane adds its pieces' sums to its own in order. The warp so steps as often
// as the pieces need, not as the longest run; the sums are the same bits on
// every run either way.
template <int MASK, bool POW2>
__device__ __forceinline__ void walk_part(const float* __restrict__ buf, int lo, int hi, int c0,
                                          const Faces& g, Sums& s, float* __restrict__ scratch,
                                          int lane, int z0) {
  const int len = max(hi - lo, 0);
  const int longest = __reduce_max_sync(kAll, len);
  const int pieces = (len + kPiece - 1) / kPiece;
  int first = 0, dealt = 0;  // this run's first piece, and the warp's pieces
  if (longest >= 4 * kPiece) {
    first = inclusive_scan(pieces, lane) - pieces;
    dealt = __shfl_sync(kAll, first + pieces, 31);
  }
  const int rounds = (dealt + 31) / 32;
  // Shared only where that also at least halves the warp's steps.
  if (dealt == 0 || 2 * rounds * kPiece > longest) {
    walk<MASK, POW2>(buf, lo, hi, c0, g, s);
    return;
  }
  for (int r = 0; r < rounds; ++r) {
    const int it = r * 32 + lane;
    // The run that holds piece it: the last lane whose first piece is at or
    // before it (a lane with no piece shares its first with the next).
    int t = 0;
    for (int step = 16; step >= 1; step >>= 1) {
      if (__shfl_sync(kAll, first, t + step) <= it) t += step;
    }
    const int tlo = __shfl_sync(kAll, lo, t), thi = __shfl_sync(kAll, hi, t);
    const int tfirst = __shfl_sync(kAll, first, t);
    Sums p;
    if (it < dealt) {
      Faces gt = g;
      gt.f[2] = static_cast<float>(z0 + t);
      const int a = tlo + (it - tfirst) * kPiece;
      walk<MASK, POW2>(buf, a, min(a + kPiece, thi), c0, gt, p);
    }
    float* mine = scratch + 6 * lane;
    mine[0] = p.au, mine[1] = p.mu, mine[2] = p.av, mine[3] = p.mv, mine[4] = p.aw, mine[5] = p.mw;
    __syncwarp();
    for (int q = max(first, r * 32); q < min(first + pieces, r * 32 + 32); ++q) {
      const float* o = scratch + 6 * (q - r * 32);
      if (MASK & kU) s.au += o[0], s.mu += o[1];
      if (MASK & kV) s.av += o[2], s.mv += o[3];
      if (MASK & kW) s.aw += o[4], s.mw += o[5];
    }
    __syncwarp();
  }
}

__device__ __forceinline__ void put(float* __restrict__ g, bool* __restrict__ ok, long long at,
                                    float acc, float amt, float thresh, bool boundary) {
  if (boundary) {
    g[at] = 0.0f;
    ok[at] = true;
    return;
  }
  // torch's clamp(min=1e-30): NaN stays NaN.
  const float lo = static_cast<float>(1e-30);
  g[at] = acc / (amt < lo ? lo : amt);
  ok[at] = amt > thresh;
}

template <bool POW2>
__global__ void __launch_bounds__(kThreads, 2)
p2g_apic_kernel(const float* __restrict__ pcs, const float* __restrict__ vels,
                const float* __restrict__ cs, const int* __restrict__ start, int n,
                float* __restrict__ gu, float* __restrict__ gv, float* __restrict__ gw,
                bool* __restrict__ ou, bool* __restrict__ ov, bool* __restrict__ ow,
                int nx, int ny, int nz, float thresh) {
  extern __shared__ float smem[];
  float* buffers = smem;  // [2][kFields][kField]
  // first[c * kZ + zl]: global CSR slot of halo cell zl (z = z0 - 2 + zl,
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
    const int cx = x0 - kBelow + c / kHY, cy = y0 - kBelow + c % kHY;
    int s = 0;
    if (cx >= 0 && cx < nx && cy >= 0 && cy < ny) {
      const int z = min(max(z0 - kBelow + zl, 0), nz);
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
      for (int e = lane; e < 9 * (hi - lo); e += 32) {
        copy_async(buf + (6 + e % 9) * kField + slot(lo - c0 + e / 9), cs + 9 * g + e);
      }
    }
    commit_copies();
  };

  const bool row = i < nx && j < ny;  // the same for the 32 lanes of a warp
  const bool active = row && k < nz;
  float* scratch = reinterpret_cast<float*>(shift + kCols) + warp * kScratch;
  const Faces g{{static_cast<float>(i), static_cast<float>(j), static_cast<float>(k)},
                {static_cast<float>(nx), static_cast<float>(ny), static_cast<float>(nz)},
                {1.0f / nx, 1.0f / ny, 1.0f / nz}};
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
    if (row) {
      const int c0 = t * kChunk, c1 = min(c0 + kChunk, total);
      const float* buf = buffers + (t & 1) * kBuffer;
      // Column (i-2+dx, j-2+dy); its cells k-2 .. k+1 are the offsets
      // f[0] .. f[4].
      for (int dx = 0; dx < kWin; ++dx) {
        for (int dy = 0; dy < kWin; ++dy) {
          if (dx == 0 && dy == 0) continue;
          const int c = (li + dx) * kHY + lj + dy;
          const int* f = first + c * kZ + lk;
          const int sh = shift[c];
          // The run of cells f[a] .. f[b] - 1 within the chunk; none past
          // the grid.
          auto part = [&](int a, int b, auto mask) {
            const int lo = active ? max(f[a] + sh, c0) : 0;
            const int hi = active ? min(f[b] + sh, c1) : 0;
            walk_part<decltype(mask)::value, POW2>(buf, lo, hi, c0, g, s, scratch, lane, z0);
          };
          if (dx == 0) {
            part(1, 4, std::integral_constant<int, kU>());
          } else if (dy == 0) {
            part(1, 4, std::integral_constant<int, kV>());
          } else {
            part(0, 1, std::integral_constant<int, kW>());
            part(1, 4, std::integral_constant<int, kU | kV | kW>());
          }
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
  const long long ncell = static_cast<long long>(nx) * ny * nz;
  for (int q = start[ncell]; q < n; ++q) {
    const long long p = q;
    visit<kU | kV | kW, POW2>(
        [&](int f) {
          return f < 3 ? pcs[3 * p + f] : f < 6 ? vels[3 * p + f - 3] : cs[9 * p + f - 6];
        },
        g, s);
  }

  // U is (nx+1, ny, nz), V (nx, ny+1, nz), W (nx, ny, nz+1).
  const long long u = (static_cast<long long>(i) * ny + j) * nz + k;
  const long long v = (static_cast<long long>(i) * (ny + 1) + j) * nz + k;
  const long long w = (static_cast<long long>(i) * ny + j) * (nz + 1) + k;
  put(gu, ou, u, s.au, s.mu, thresh, i == 0);
  put(gv, ov, v, s.av, s.mv, thresh, j == 0);
  put(gw, ow, w, s.aw, s.mw, thresh, k == 0);
  if (i == nx - 1) put(gu, ou, u + static_cast<long long>(ny) * nz, 0.0f, 0.0f, thresh, true);
  if (j == ny - 1) put(gv, ov, v + nz, 0.0f, 0.0f, thresh, true);
  if (k == nz - 1) put(gw, ow, w + 1, 0.0f, 0.0f, thresh, true);
}

template <bool POW2>
int launch(const float* pcs, const float* vels, const float* cs, const int* start, int n,
           float* gu, float* gv, float* gw, bool* ou, bool* ov, bool* ow, int nx, int ny,
           int nz, float thresh, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      p2g_apic_kernel<POW2>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY, (nz + kTZ - 1) / kTZ);
  p2g_apic_kernel<POW2><<<grid, kThreads, kSmem, stream>>>(
      pcs, vels, cs, start, n, gu, gv, gw, ou, ov, ow, nx, ny, nz, thresh);
  return static_cast<int>(cudaGetLastError());
}

bool pow2(int v) { return (v & (v - 1)) == 0; }

}  // namespace

// pcs (n, 3) positions in cell units, vels (n, 3), cs (n, 3, 3), all in the
// CSR order of start (nx*ny*nz + 1 offsets; ops/binning.py); u, v, w and
// their validity uv, vv, wv: the MAC grids, written whole.
extern "C" int fst_p2g_apic(const float* pcs, const float* vels, const float* cs,
                            const int* start, int n, float* u, float* v, float* w,
                            bool* uv, bool* vv, bool* wv, int nx, int ny, int nz,
                            float thresh, void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (pow2(nx) && pow2(ny) && pow2(nz)) {
    return launch<true>(pcs, vels, cs, start, n, u, v, w, uv, vv, wv, nx, ny, nz, thresh, s);
  }
  return launch<false>(pcs, vels, cs, start, n, u, v, w, uv, vv, wv, nx, ny, nz, thresh, s);
}

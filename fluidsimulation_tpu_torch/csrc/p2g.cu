// P2G accumulators over the CSR particle index: a deterministic gather by
// cell tiles, the particles staged through shared memory a halo plane at a
// time, the long runs' walk dealt out over the whole block in pieces.
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
// but the walk: every particle is visited for each of the 27 cells around
// it, each visit a chain of shared loads, hats, products and sums. The
// amount of that work does not depend on where the particles are; how it
// falls on the threads does. Particles pile up at the walls (the advection
// clamp puts them on the boundary planes: 159 in one cell at 128^3 ppc 1
// after 20 steps, 3,320 in the demo after 60) and in the splash's dense
// cells (over 22,000 in one cell at 256^3), and a block waits for its
// busiest thread (PERF.md, section 6).
//
// Design:
//   * A block owns a tile of 1 x 8 x 32 cells, z fastest, one thread a
//     cell, so a warp is 32 consecutive z. A face of the tile is the cell
//     (i, j, k): the U, V and W faces with that index, and on the grid's
//     upper edge also the last face layer (index nx, ny or nz). Its
//     particles lie in the 3 x 3 columns around it, in each column
//     (i-1+DX, j-1+DY) in the cells k-1 .. k+1: one run of CSR slots, as
//     cells are linearised with z fastest (ops/binning.py). One walk of a
//     run serves the three components: U is skipped in the columns DX = 2,
//     V in DY = 2 (the hat of the own axis is 0 there), and the x and y
//     hats need no search (see plain_hat).
//   * The halo, the tile grown by one cell on each side, is staged in
//     shared memory one x-plane at a time: the plane DX (10 columns, in
//     (cx, cy) order, each one contiguous run of CSR slots) holds column DX
//     of every face's window, so every warp has three runs to walk in each
//     plane, as many as its neighbours where the particles lie evenly. The
//     block copies the plane with 4 B cp.async (any alignment) into six
//     arrays x, y, z, vx, vy, vz; a plane of more than kChunk particles is
//     taken in chunks of kChunk halo positions, so shared memory does not
//     grow with a pile or the grid.
//   * A face walks its own short runs (kLong positions or fewer), particle
//     by particle. A long run (a dense cell, a pile) is cut into pieces of
//     kPiece positions at fixed offsets from its start, and the block deals
//     a chunk's pieces out: it lists them column by column and face by face
//     (a block-wide scan), marks where each run's pieces begin in a round
//     of 256 slots, and each warp, done with its faces' own runs, takes the
//     first round's slots 32 at a time while any are left; later rounds
//     give one piece to a thread. A piece is summed from zero into its
//     slot of partial sums. Then each face adds its pieces of the round in
//     list order; a run with kShare or more pieces in the round is added
//     by the face's warp, each pair of sums on a lane of its own, in the
//     same order. A piece that a chunk's end cuts keeps its partial in the
//     face's carry, and the face finishes it in the next chunk from there.
// The order rule: a face's sum is (its short runs' particles in CSR order,
// column by column) + (its long runs' pieces' partials, in the order column,
// then piece along the run, each partial summed in slot order from zero).
// Whether a run is long, and where its pieces lie, depend on the run alone;
// a partial continued from its carry adds in the same order as an uncut
// piece. So a face's bits depend only on the particles of its own 27-cell
// window in CSR order, not on the block's other columns nor on where
// chunks, rounds and warps fall (a multi-rank step's slab, which holds
// other particles elsewhere, gives its own faces the one-device step's
// bits). The union of the three windows adds, for a component, particles
// whose weight is exactly 0, and adding +-0 changes no value. Compiled with
// -fmad=false and with no atomics on the faces, the result is the same bits
// on every run; it differs from the scatter form by summation order only.
// Any nx, ny, nz >= 1: ragged tiles are masked. A particle the CSR index
// keeps past start[ncell] (a non-finite position) lies in no run and is
// never read.
// Shared memory a block: the buffer (6 arrays x kField floats, a 32-slot
// row padded by one float, fields 11 banks apart), the halo's offsets, the
// list (3 x 256 + 1 ints), the round's partials (6 pairs of sums x 256),
// the listed runs' first pieces and ends, the round's heads and masks and
// the listing scan's warp totals: 114,400 B a block, two blocks an SM.
// Counters: given a device pointer (ops/cuda_p2g.py passes one while a
// recording of utils/trace.py is open; null otherwise), each block adds at
// its end [0] the particle visits its threads walked (p2g.visits) and [1]
// 256 times the longest thread's steps of each phase (a chunk's own walk
// with the first round, each later round), summed over its phases
// (p2g.lane_steps). lane_steps / visits is the lane-steps the block spent a
// visit: 1 where no thread ever waits for another.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTZ = 32;        // cells a tile along z: one warp
constexpr int kTX = 1, kTY = 8;  // cells a tile along x and y
constexpr int kThreads = kTX * kTY * kTZ;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 3520;   // halo positions the buffer holds: a plane at up to 10 a cell
// One float of padding after every 32 slots spreads the slots that lanes
// walking different runs and pieces read over the banks; fields then lie
// 11 banks apart.
constexpr int kField = kChunk + kChunk / 32 + 11;
constexpr int kBuffer = 6 * kField;
constexpr int kHY = kTY + 2;  // halo columns of a plane (one halo x)
constexpr int kCols = (kTX + 2) * (kTY + 2);  // halo columns
constexpr int kZ = kTZ + 3;  // offsets of halo cells z0-1 .. z0+32, and the end
constexpr int kLong = 64;    // a run of more halo positions is dealt out
constexpr int kPiece = 32;   // halo positions a piece: the unit the block deals
constexpr int kShare = 32;   // pieces of a run in a round that its warp adds
constexpr int kRuns = 3;     // runs a face walks in a plane: its columns DY = 0, 1, 2
constexpr int kList = kRuns * kThreads;  // (column, face) runs of a chunk's list
constexpr int kPairs = 6;    // (acc, amt) pairs of a face: U, V, W, U1, V1, W1
// Shared memory, in 4 B words: the buffer, the halo's offsets (first,
// shift), the list, the round's partials (float2, 8 B aligned), the
// listed runs' first pieces and ends, the round's run heads and their
// masks, the listing scan's warp totals.
constexpr int kFirst = kBuffer;
constexpr int kShift = kFirst + kCols * kZ;
constexpr int kListAt = kShift + kCols;
constexpr int kPart = (kListAt + kList + 1 + 1) / 2 * 2;
constexpr int kRunAt = kPart + 2 * kPairs * kThreads;
constexpr int kHeads = kRunAt + 2 * kList;
constexpr int kMasks = kHeads + kThreads;
constexpr int kWsum = kMasks + 2 * kWarps;
constexpr int kSmem = 4 * (kWsum + kRuns * kWarps);
static_assert(kCols <= 64, "the column scan covers two warp widths");
static_assert(kRuns * kWarps <= 3 * 32, "the list's warp totals are scanned three a lane");
static_assert(kTX == 1, "a halo plane holds one column (DX) of every face's window");
static_assert(kPiece <= kChunk, "a piece the chunk's end cuts ends in the next chunk");
// Two blocks an SM: 228 KB of shared memory, 1 KB of it reserved a block.
static_assert(2 * (kSmem + 64 + 1024) <= 233472, "two blocks fit an SM");

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

// The sums of one face, or of one piece of its walk: its U, V and W faces,
// and the last face layer where the face lies on the grid's upper edge.
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

// The face's index f along one axis, and the particle's cell
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

// Walk the buffer positions [lo, hi) of face (i, j, k)'s run in column
// (i - 1 + DX, j - 1 + DY), whose x and y cells are cx and cy, into s. Along
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

// A face of the tile: cell f of the block's 256, z fastest.
struct Face {
  int li, lj, lk;          // in the tile
  int i, j, k;             // in the grid
  bool active, ex, ey, ez;  // inside the grid; on its upper edge along x, y, z
};

struct Tile {
  int x0, y0, z0, nx, ny, nz;
};

__device__ __forceinline__ Face face_of(int f, const Tile& t) {
  Face F;
  F.lk = f % kTZ;
  F.lj = (f / kTZ) % kTY;
  F.li = f / (kTZ * kTY);
  F.i = t.x0 + F.li;
  F.j = t.y0 + F.lj;
  F.k = t.z0 + F.lk;
  F.active = F.i < t.nx && F.j < t.ny && F.k < t.nz;
  F.ex = F.i == t.nx - 1;
  F.ey = F.j == t.ny - 1;
  F.ez = F.k == t.nz - 1;
  return F;
}

// The halo positions [h0, h3) of face F's run in column n = 3 DX + DY: the
// particles of cells k-1 .. k+1 of column (i-1+DX, j-1+DY).
__device__ __forceinline__ int2 run_of(const int* first, const int* shift, int n,
                                       const Face& F) {
  const int c = (F.li + n / 3) * kHY + F.lj + n % 3;
  const int* p = first + c * kZ + F.lk;
  return make_int2(p[0] + shift[c], p[3] + shift[c]);
}

// Pair q (U, V, W, U1, V1, W1) of a face's sums.
__device__ __forceinline__ float2 get_pair(const Sums& s, int q) {
  switch (q) {
    case 0: return make_float2(s.au, s.mu);
    case 1: return make_float2(s.av, s.mv);
    case 2: return make_float2(s.aw, s.mw);
    case 3: return make_float2(s.au1, s.mu1);
    case 4: return make_float2(s.av1, s.mv1);
    default: return make_float2(s.aw1, s.mw1);
  }
}

__device__ __forceinline__ void set_pair(Sums& s, int q, float2 v) {
  switch (q) {
    case 0: s.au = v.x, s.mu = v.y; break;
    case 1: s.av = v.x, s.mv = v.y; break;
    case 2: s.aw = v.x, s.mw = v.y; break;
    case 3: s.au1 = v.x, s.mu1 = v.y; break;
    case 4: s.av1 = v.x, s.mv1 = v.y; break;
    default: s.aw1 = v.x, s.mw1 = v.y; break;
  }
}

__device__ __forceinline__ float2 plus(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// Bit q set: pair q is one that the particles of face F's column (DX, dy)
// reach: U but in the columns DX = 2, V but in dy = 2, W, and the last
// face layers on the grid's upper edges.
template <int DX>
__device__ __forceinline__ unsigned reaches(int dy, const Face& F) {
  return (DX < 2 ? 1u : 0u) | (dy < 2 ? 2u : 0u) | 4u | (DX == 1 && F.ex ? 8u : 0u) |
         (dy == 1 && F.ey ? 16u : 0u) | (F.ez ? 32u : 0u);
}

// to += s, in the pairs `reach` names.
__device__ __forceinline__ void add(Sums& to, const Sums& s, unsigned reach) {
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    if (reach >> q & 1u) set_pair(to, q, plus(get_pair(to, q), get_pair(s, q)));
  }
}

// Walk the piece [s0, s0 + kPiece) of face F's long run in column (DX, DY),
// which ends at h3, as far as it lies in the chunk (to c1), from zero, and
// leave its partial sums in slot `at` of part. Returns the positions walked.
template <int DX, int DY>
__device__ __forceinline__ int walk_piece(const float* __restrict__ buf, const Face& F, int s0,
                                          int h3, int c0, int c1, int xo, float2* part, int at) {
  const int hi = min(min(s0 + kPiece, h3), c1);
  Sums s;
  // The particles' x is in the frame of the domain, whose plane xo is the
  // grid's plane 0 (a rank's extended slab; 0 for a whole grid).
  const float fi = static_cast<float>(F.i + xo), fj = static_cast<float>(F.j);
  walk_run<DX, DY>(buf, s0, hi, c0, fi + (DX - 1.0f), fj + (DY - 1.0f), static_cast<float>(F.k),
                   F.ex, F.ey, F.ez, s);
  const unsigned reach = reaches<DX>(DY, F);
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    if (reach >> q & 1u) part[q * kThreads + at] = get_pair(s, q);
  }
  return hi - s0;
}

// Add the partials in part's slots [lo, hi) to the pairs of sums `reach`
// names, slot by slot.
__device__ __forceinline__ void fold_run(const float2* part, int lo, int hi, unsigned reach,
                                         Sums& s) {
#pragma unroll 2
  for (int sl = lo; sl < hi; ++sl) {
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      if (reach >> q & 1u) set_pair(s, q, plus(get_pair(s, q), part[q * kThreads + sl]));
    }
  }
}

// fold_run for lane `leader` of the warp, the warp's lanes 0 .. 5 each
// adding one pair of its sums over the leader's slots, in the same order.
__device__ __forceinline__ void fold_shared(const float2* part, int leader, int lane, int lo,
                                            int hi, unsigned reach, Sums& s) {
  const unsigned all = 0xffffffffu;
  lo = __shfl_sync(all, lo, leader);
  hi = __shfl_sync(all, hi, leader);
  reach = __shfl_sync(all, reach, leader);
  float2 v = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const float2 p = get_pair(s, q);
    const float2 b = make_float2(__shfl_sync(all, p.x, leader), __shfl_sync(all, p.y, leader));
    if (lane == q) v = b;
  }
  if (lane < kPairs && (reach >> lane & 1u)) {
#pragma unroll 4
    for (int sl = lo; sl < hi; ++sl) v = plus(v, part[lane * kThreads + sl]);
  }
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const float2 b = make_float2(__shfl_sync(all, v.x, q), __shfl_sync(all, v.y, q));
    if (lane == leader) set_pair(s, q, b);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
p2g_tile_kernel(const float* __restrict__ pcs, const float* __restrict__ vels,
                const int* __restrict__ start, float* __restrict__ acc_u,
                float* __restrict__ amt_u, float* __restrict__ acc_v,
                float* __restrict__ amt_v, float* __restrict__ acc_w,
                float* __restrict__ amt_w, int nx, int ny, int nz, int xo,
                unsigned long long* __restrict__ counters) {
  extern __shared__ float smem[];
  float* buffers = smem;  // [x, y, z, vx, vy, vz][kField]
  // first[c * kZ + zl]: global CSR slot of halo cell zl (z = z0 - 1 + zl,
  // clamped to [0, nz]) of column c; 0 for a column off the grid.
  int* first = reinterpret_cast<int*>(smem + kFirst);
  // shift[c]: halo position minus global slot, within column c.
  int* shift = reinterpret_cast<int*>(smem + kShift);
  // list[n * kThreads + f]: the chunk's first dealt piece of face f's long
  // run in column n, the pieces listed column by column, faces in order
  // within a column; list[kList]: the chunk's dealt pieces.
  int* list = reinterpret_cast<int*>(smem + kListAt);
  // part[q * kThreads + s]: pair q of the partial sums of the round's piece s.
  float2* part = reinterpret_cast<float2*>(smem + kPart);
  // run_at[e], run_end[e]: the halo position of list entry e's first dealt
  // piece in the chunk, and of its run's end.
  int* run_at = reinterpret_cast<int*>(smem + kRunAt);
  int* run_end = run_at + kList;
  // head[s]: the list entry whose pieces begin at slot s of the round;
  // masks[(round % 2) * kWarps + w] bit b: some entry's pieces begin at
  // slot 32 w + b.
  int* head = reinterpret_cast<int*>(smem + kHeads);
  unsigned* masks = reinterpret_cast<unsigned*>(smem + kMasks);
  int* wsum = reinterpret_cast<int*>(smem + kWsum);  // [column][warp]
  __shared__ int round_max;
  __shared__ int grabbed;  // the first round's pieces taken
  __shared__ unsigned long long block_visits;

  const Tile tile{static_cast<int>(blockIdx.x) * kTX, static_cast<int>(blockIdx.y) * kTY,
                  static_cast<int>(blockIdx.z) * kTZ, nx, ny, nz};
  const int x0 = tile.x0, y0 = tile.y0, z0 = tile.z0;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const Face me = face_of(tid, tile);

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
  if (tid == 0) round_max = 0, grabbed = 0, block_visits = 0;
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
  }
  __syncthreads();

  // Copy halo positions [c0, c1) of the plane whose first column is a
  // into the buffer: warp w takes every kWarps-th column, its lanes the
  // column's particles in order.
  auto load = [&](int a, int c0, int c1) {
    for (int c = a + warp; c < a + kHY; c += kWarps) {
      const int g0 = first[c * kZ];
      const int h0 = g0 + shift[c], h1 = first[c * kZ + kZ - 1] + shift[c];
      const int lo = max(h0, c0), hi = min(h1, c1);
      const long long g = static_cast<long long>(g0) + (lo - h0);
      for (int q = lane; q < hi - lo; q += 32) {
        const int at = slot(lo - c0 + q);
        const float* p = pcs + 3 * (g + q);
        const float* v = vels + 3 * (g + q);
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          copy_async(buffers + d * kField + at, p + d);
          copy_async(buffers + (3 + d) * kField + at, v + d);
        }
      }
    }
    commit_copies();
  };

  // The face's sums: over its short runs, particle by particle (s); over
  // its long runs, piece by piece (dealt); the piece a chunk's end cut.
  Sums s, dealt, carry;
  const float fi = static_cast<float>(me.i + xo), fj = static_cast<float>(me.j);
  const float fk = static_cast<float>(me.k);
  unsigned visits = 0;
  unsigned long long lane_steps = 0;

  // The halo's plane DX (its columns DX * kHY ..), chunk by chunk: every
  // face walks its window's column DX there.
  auto plane = [&](auto dxc) {
    constexpr int DX = decltype(dxc)::value;
    const int a = DX * kHY, b = a + kHY - 1;
    const int p0 = first[a * kZ] + shift[a], p1 = first[b * kZ + kZ - 1] + shift[b];
    for (int c0 = p0; c0 < p1; c0 += kChunk) {
      const int c1 = min(c0 + kChunk, p1);
      load(a, c0, c1);

      // While the copies fly: the face's long runs, whose pieces that begin
      // in the chunk are dealt (the one the chunk before cut is the face's
      // own to finish), and their list.
      int cnt[kRuns], first_piece[kRuns], run_y[kRuns];
#pragma unroll
      for (int n = 0; n < kRuns; ++n) {
        cnt[n] = 0, first_piece[n] = 0, run_y[n] = 0;
        const int2 r = run_of(first, shift, 3 * DX + n, me);
        if (!me.active || r.y - r.x <= kLong) continue;
        int lo = max(r.x, c0);
        if (lo < r.y && (lo - r.x) % kPiece != 0) lo = min(r.x + ((lo - r.x) / kPiece + 1) * kPiece, r.y);
        const int hi = min(r.y, c1);
        if (lo < hi) cnt[n] = (hi - lo + kPiece - 1) / kPiece;
        first_piece[n] = lo;
        run_y[n] = r.y;
      }
      bool any = false;
#pragma unroll
      for (int n = 0; n < kRuns; ++n) any = any || cnt[n] > 0;
      any = __syncthreads_or(any);

      // List them: column by column, faces in order within a column.
      int pieces = 0;
      if (any) {
        int inc[kRuns];
#pragma unroll
        for (int n = 0; n < kRuns; ++n) {
          inc[n] = inclusive_scan(cnt[n], lane);
          if (lane == 31) wsum[n * kWarps + warp] = inc[n];
        }
        if (tid < 2 * kWarps) masks[tid] = 0u;
        if (tid == 0) grabbed = 0;
        __syncthreads();
        if (warp == 0) {
          // Exclusive scan of the warp totals in (column, warp) order, three a lane.
          int v[3], sum = 0;
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            const int e = 3 * lane + m;
            v[m] = e < kRuns * kWarps ? wsum[e] : 0;
            sum += v[m];
          }
          int before = inclusive_scan(sum, lane) - sum;
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            const int e = 3 * lane + m;
            if (e < kRuns * kWarps) wsum[e] = before;
            before += v[m];
          }
          if (lane == 31) list[kList] = before;
        }
        __syncthreads();
#pragma unroll
        for (int n = 0; n < kRuns; ++n) {
          const int e = n * kThreads + tid;
          list[e] = wsum[n * kWarps + warp] + inc[n] - cnt[n];
          run_at[e] = first_piece[n];
          run_end[e] = run_y[n];
        }
        __syncthreads();
        pieces = list[kList];
      }

      // Mark the slots where the face's runs begin their pieces in round
      // [r0, r0 + kThreads).
      int mark_from = 0;  // the face's first run with pieces at or after the round
      auto mark = [&](int r0, unsigned* mask) {
        const int r1 = min(r0 + kThreads, pieces);
        for (int n = mark_from; n < kRuns; ++n) {
          const int e = n * kThreads + tid, b0 = list[e], b1 = list[e + 1];
          if (b0 >= r1) break;
          if (b1 <= r0) {
            mark_from = n + 1;
            continue;
          }
          if (b0 == b1) continue;
          const int at = max(b0, r0) - r0;
          head[at] = e;
          atomicOr(mask + at / 32, 1u << (at % 32));
        }
      };
      // Walk piece g of the list, of round [r0, ...): a piece of the run
      // marked at or before its slot. Returns the positions walked.
      auto deal = [&](int r0, int g, const unsigned* mask) {
        const int sl = g - r0;
        int w = sl / 32;
        unsigned bits = mask[w] & (0xffffffffu >> (31 - sl % 32));
        while (bits == 0u) bits = mask[--w];
        const int e = head[32 * w + 31 - __clz(bits)];
        const int n = e / kThreads, s0 = run_at[e] + (g - list[e]) * kPiece;
        const Face F = face_of(e % kThreads, tile);
        if (n == 0) return walk_piece<DX, 0>(buffers, F, s0, run_end[e], c0, c1, xo, part, sl);
        if (n == 1) return walk_piece<DX, 1>(buffers, F, s0, run_end[e], c0, c1, xo, part, sl);
        return walk_piece<DX, 2>(buffers, F, s0, run_end[e], c0, c1, xo, part, sl);
      };
      if (any) mark(0, masks);
      wait_copies<0>();
      __syncthreads();  // the chunk has landed; the first round is marked

      // The face's own walk: its short runs, and the rest of the long run's
      // piece the chunk before cut, from the carry into the dealt sums.
      int steps = 0;
      auto column = [&](auto dyc) {
        constexpr int DY = decltype(dyc)::value;
        if (!me.active) return;
        const int2 r = run_of(first, shift, 3 * DX + DY, me);
        const float cx = fi + (DX - 1.0f), cy = fj + (DY - 1.0f);
        if (r.y - r.x <= kLong) {
          const int lo = max(r.x, c0), hi = min(r.y, c1);
          walk_run<DX, DY>(buffers, lo, hi, c0, cx, cy, fk, me.ex, me.ey, me.ez, s);
          steps += max(hi - lo, 0);
          return;
        }
        const int lo = max(r.x, c0);
        if (lo < r.y && (lo - r.x) % kPiece != 0) {
          // lo == c0 inside a piece: it ends in this chunk (kPiece <= kChunk).
          const int hi = min(r.x + ((lo - r.x) / kPiece + 1) * kPiece, r.y);
          walk_run<DX, DY>(buffers, lo, hi, c0, cx, cy, fk, me.ex, me.ey, me.ez, carry);
          add(dealt, carry, reaches<DX>(DY, me));
          carry = Sums();
          steps += hi - lo;
        }
      };
      column(std::integral_constant<int, 0>());
      column(std::integral_constant<int, 1>());
      column(std::integral_constant<int, 2>());
      // Then the warp takes the first round's pieces, 32 at a time, while
      // any are left: warps with less of their own walk walk more of them.
      for (const int limit = min(pieces, kThreads); any;) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&grabbed, 32);
        base = __shfl_sync(0xffffffffu, base, 0);
        if (base >= limit) break;
        if (base + lane < limit) steps += deal(0, base + lane, masks);
      }
      if (counters != nullptr) {
        const int longest = __reduce_max_sync(0xffffffffu, steps);
        if (lane == 0) atomicMax(&round_max, longest);
        visits += steps;
      }
      __syncthreads();  // unless pieces are dealt, the buffer is free for the next chunk
      if (counters != nullptr && tid == 0) lane_steps += round_max, round_max = 0;
      if (!any) continue;

      int fold_from = 0;  // the face's first run not wholly added
      for (int r0 = 0, round = 0; r0 < pieces; r0 += kThreads, ++round) {
        const int r1 = min(r0 + kThreads, pieces);
        unsigned* mask = masks + (round & 1) * kWarps;
        unsigned* next = masks + ((round + 1) & 1) * kWarps;
        if (round > 0) {
          // Slot tid of the round, one piece a thread.
          const int walked = r0 + tid < r1 ? deal(r0, r0 + tid, mask) : 0;
          if (tid < kWarps) next[tid] = 0u;
          if (counters != nullptr) {
            const int longest = __reduce_max_sync(0xffffffffu, walked);
            if (lane == 0) atomicMax(&round_max, longest);
            visits += walked;
          }
          __syncthreads();
          if (counters != nullptr && tid == 0) lane_steps += round_max, round_max = 0;
        }

        // Each face adds its pieces of the round, in list order, run by
        // run; the piece the chunk's end cuts waits in the carry. A run with
        // kShare or more pieces in the round is added by the face's warp,
        // each pair of sums on a lane of its own, in the same order.
        int n = fold_from;
        for (;;) {
          int e = 0, lo = 0, hi = 0, end = 0;
          bool have = false;
          for (; n < kRuns; ++n) {
            e = n * kThreads + tid;
            const int b0 = list[e], b1 = list[e + 1];
            if (b0 >= r1) {
              n = kRuns;
              break;
            }
            lo = max(b0, r0) - r0, hi = min(b1, r1) - r0;
            if (b1 <= r1) fold_from = n + 1;
            if (lo >= hi) continue;
            end = hi;
            if (b1 <= r1) {
              // The run's last piece in the chunk: cut if the run goes on
              // past the chunk's end and no piece boundary falls there.
              const int at = run_at[e] + (b1 - 1 - b0) * kPiece;
              if (run_end[e] > c1 && at + kPiece > c1) end = hi - 1;
            }
            have = true;
            break;
          }
          if (!__any_sync(0xffffffffu, have)) break;
          const bool shared = have && end - lo >= kShare;
          const unsigned reach = reaches<DX>(n, me);
          if (have && !shared) fold_run(part, lo, end, reach, dealt);
          for (unsigned leaders = __ballot_sync(0xffffffffu, shared); leaders != 0u;
               leaders &= leaders - 1) {
            fold_shared(part, __ffs(leaders) - 1, lane, lo, end, reach, dealt);
          }
          if (have && end < hi) {
            // Every pair; those the run's column does not reach are never read.
#pragma unroll
            for (int q = 0; q < kPairs; ++q) set_pair(carry, q, part[q * kThreads + end]);
          }
          if (have) ++n;
        }
        if (r1 < pieces) mark(r1, next);
        __syncthreads();
      }
    }
  };
  plane(std::integral_constant<int, 0>());
  plane(std::integral_constant<int, 1>());
  plane(std::integral_constant<int, 2>());

  if (counters != nullptr) {
    const unsigned warp_visits = __reduce_add_sync(0xffffffffu, visits);
    if (lane == 0) atomicAdd(&block_visits, static_cast<unsigned long long>(warp_visits));
    __syncthreads();
    if (tid == 0) {
      atomicAdd(counters, block_visits);
      atomicAdd(counters + 1, static_cast<unsigned long long>(kThreads) * lane_steps);
    }
  }

  if (!me.active) return;
  const int i = me.i, j = me.j, k = me.k;
  // U is (nx+1, ny, nz), V (nx, ny+1, nz), W (nx, ny, nz+1).
  const long long u = (static_cast<long long>(i) * ny + j) * nz + k;
  const long long v = (static_cast<long long>(i) * (ny + 1) + j) * nz + k;
  const long long w = (static_cast<long long>(i) * ny + j) * (nz + 1) + k;
  acc_u[u] = s.au + dealt.au;
  amt_u[u] = s.mu + dealt.mu;
  acc_v[v] = s.av + dealt.av;
  amt_v[v] = s.mv + dealt.mv;
  acc_w[w] = s.aw + dealt.aw;
  amt_w[w] = s.mw + dealt.mw;
  if (me.ex) {
    const long long u1 = u + static_cast<long long>(ny) * nz;
    acc_u[u1] = s.au1 + dealt.au1;
    amt_u[u1] = s.mu1 + dealt.mu1;
  }
  if (me.ey) {
    acc_v[v + nz] = s.av1 + dealt.av1;
    amt_v[v + nz] = s.mv1 + dealt.mv1;
  }
  if (me.ez) {
    acc_w[w + 1] = s.aw1 + dealt.aw1;
    amt_w[w + 1] = s.mw1 + dealt.mw1;
  }
}

}  // namespace
// x0: the grid's plane 0 is plane x0 of the domain, in whose cell units pcs
// are (a rank's extended slab in parallel/halo_step.py): the CSR runs are
// the grid's cells, floor(p + 0.5) - x0 along x. 0 for a whole grid.
// counters: null, or two int64 counters on the device the kernel adds to
// (p2g.visits, p2g.lane_steps; see the header).
extern "C" int fst_p2g(const float* pcs, const float* vels, const int* start,
                       float* acc_u, float* amt_u, float* acc_v, float* amt_v,
                       float* acc_w, float* amt_w, int nx, int ny, int nz, int x0,
                       long long* counters, void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaFuncSetAttribute(
      p2g_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess) {
    // Two blocks an SM need the largest shared-memory carveout.
    err = cudaFuncSetAttribute(p2g_tile_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY, (nz + kTZ - 1) / kTZ);
  p2g_tile_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      pcs, vels, start, acc_u, amt_u, acc_v, amt_v, acc_w, amt_w, nx, ny, nz, x0,
      reinterpret_cast<unsigned long long*>(counters));
  return static_cast<int>(cudaGetLastError());
}

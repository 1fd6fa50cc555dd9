// The directional fast sweeps of the level set's closest-candidate field:
// any list of sweeps, in order, from one C call.
//
// Replaces fluidsimulation_tpu/ops/pallas_sweep.py::_sweep_kernel (driven
// by _sweep_major and sweep_closest_pallas), the TPU form of
// ops/levelset.py::_sweep_axis and of gpClosestParticlesSweep{X,Y,Z}{m,p}.
// Along each line of the swept axis the carried candidate is the previous
// plane's resulting candidate; a cell takes the carried candidate when it
// is strictly closer than the cell's own phi, and the carry becomes the
// cell's resulting candidate. The first plane of the sweep (plane n-1 when
// reversed) is copied and never updated. fst_sweeps launches one kernel a
// sweep on the stream: each sweep must see the whole result of the one
// before. The first reads the inputs, the rest work in place on the output.
//
// Bound on the H100. Bytes: each sweep reads and writes phi and cpos once,
// 2 x 16 B a cell (67 MB at 128^3, 20 us at 3.35 TB/s; 0.48 ms for 24
// sweeps, less where the 34 MB of fields stay in the 50 MB L2). Latency:
// each line is a serial chain of len dependent steps (a distance, an IEEE
// sqrt, a compare and a select, ~60 cycles from shared memory), and a
// 128^3 sweep has only 16,384 lines, so a sweep takes at least ~128 x 60
// cycles (~4 us) however many bytes the card moves. The two overlap: the
// next chunk's loads fly while the current one is walked, and at 128^3 the
// bytes set the pace (~25 us a sweep, near the card's memory rate; the L2
// does not keep the fields from one sweep to the next; PERF.md).
//
// Design: a block owns a tile of kT = 32 lines and walks them in chunks of
// kC = 32 planes along the swept axis, staged through shared memory:
//   1. copier warps copy a chunk into shared memory with cp.async (4 B a
//      copy, so any shape and alignment), coalesced: for x- and y-sweeps
//      the tile's lines are 32 consecutive z at a fixed (y or x), so each
//      plane's slice is 32 contiguous floats of phi and 96 of cpos; for
//      z-sweeps they are 32 consecutive (x, y) columns, and each column's
//      chunk is 32 contiguous z;
//   2. the walker warp, one lane a line, walks the chunk from shared
//      memory, carrying the candidate in registers from chunk to chunk;
//   3. the copier warps copy the walked chunk back, coalesced.
// The walker and the copiers meet at named barriers, two buffers deep:
// while the walker walks chunk k, the copiers store chunk k-1 and load
// chunk k+1, so the walker's chain of shared-memory loads, distances and
// selects is all that runs in series. A block is 1 walker + kCopiers = 7
// copier warps: a lone warp that also copied spent most of its time
// waiting on its own copies, and kC = 16, kT = 16, 3 or 15 copier warps
// were slower at 128^3 (PERF.md). Each chunk holds four fields
// (phi, cx, cy, cz) as [line][plane] rows padded to kC + 1 floats, so the
// walking lanes (one line each) and the copying lanes (one plane or one
// line each) hit 32 distinct banks; fields lie 11 banks apart so the
// three components of one copy do not collide.
// Shared memory a block: 2 x 4 x (32 x 33 + 11) x 4 B = 34,144 B, whatever
// the grid size: a line longer than kC is walked chunk by chunk. Grid: one
// block a tile, 512 blocks a sweep at 128^3 (all resident at once: six fit
// an SM). Ragged tiles and chunks are masked, so any nx, ny, nz >= 1 runs.
// Working in place is safe: a block reads and writes only its own lines,
// and it has read every cell of a chunk before it writes any of it.
//
// Compile with -fmad=false (see seed.cu): the strict `<` must see the same
// distance as the plain version.
#include "common.cuh"

namespace {

constexpr int kT = 32;                 // lines a tile: one walking lane each
constexpr int kC = 32;                 // planes a chunk
constexpr int kCopiers = 7;            // copier warps a block
constexpr int kBlockThreads = 32 * (1 + kCopiers);
constexpr int kRow = kC + 1;           // a line's padded row in a field
constexpr int kField = kT * kRow + 11; // floats between fields
constexpr int kBuffer = 4 * kField;    // phi, cx, cy, cz
// Named barriers: kFull + b (buffer b holds a loaded chunk), kEmpty + b
// (the walker is done with buffer b), both over the whole block; kCopied
// over the copier warps alone.
constexpr int kFull = 1, kEmpty = 3, kCopied = 5;

__device__ __forceinline__ void copy_async(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Where a tile's lines lie. Cell (line j, plane s) is
//   base + j + s * stride  (x- and y-sweeps), or
//   base + j * len + s     (z-sweeps).
struct Tile {
  long long base;
  long long stride;  // x- and y-sweeps only
  int lines;  // valid lines, <= kT
  int len;    // planes along the swept axis
};

// Copy the chunk of sweep steps [t0, t0 + nk) between device memory (phi,
// cpos) and the buffer: into the buffer with cp.async, or (kStore) back out
// with plain stores. Slot k of a row holds sweep step t0 + k. Copier warp w
// of the block takes every kCopiers-th plane (x, y) or line (z), its lanes
// the contiguous run along it.
template <int AXIS, bool kStore>
__device__ __forceinline__ void move_chunk(float* buf, float* phi, float* cpos,
                                           const Tile& tile, int t0, int nk,
                                           int reverse, int w, int lane) {
  auto move = [](float* smem, float* gmem) {
    if (kStore) {
      *gmem = *smem;
    } else {
      copy_async(smem, gmem);
    }
  };
  if (AXIS < 2) {
    // A plane at a time: the tile's slice of it is contiguous.
    for (int k = w; k < nk; k += kCopiers) {
      const int t = t0 + k;
      const long long g = tile.base + static_cast<long long>(reverse ? tile.len - 1 - t : t) * tile.stride;
      if (lane < tile.lines) move(buf + lane * kRow + k, phi + g + lane);
      for (int i = lane; i < 3 * tile.lines; i += 32) {
        move(buf + (1 + i % 3) * kField + (i / 3) * kRow + k, cpos + 3 * g + i);
      }
    }
  } else {
    // A line (column) at a time: its chunk is contiguous along z, from the
    // chunk's lowest plane up; slot k counts in sweep order.
    const int lo = reverse ? tile.len - t0 - nk : t0;
    for (int j = w; j < tile.lines; j += kCopiers) {
      const long long g = tile.base + static_cast<long long>(j) * tile.len + lo;
      if (lane < nk) move(buf + j * kRow + (reverse ? nk - 1 - lane : lane), phi + g + lane);
      for (int i = lane; i < 3 * nk; i += 32) {
        const int q = i / 3;
        move(buf + (1 + i % 3) * kField + j * kRow + (reverse ? nk - 1 - q : q), cpos + 3 * g + i);
      }
    }
  }
}

template <int AXIS>
__global__ void __launch_bounds__(kBlockThreads) sweep_tile_kernel(
    const float* phi_in, const float* cpos_in, float* phi_out, float* cpos_out,
    const float* carry_in, float* carry_out, int nx, int ny, int nz, int reverse, float r,
    int xo) {
  __shared__ float bufs[2][kBuffer];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // The tile, and the walking lane's line: its two fixed coordinates.
  Tile tile;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  if (AXIS < 2) {
    const int ztiles = (nz + kT - 1) / kT;
    const int o = blockIdx.x / ztiles;  // y for x-sweeps, x for y-sweeps
    const int z0 = (blockIdx.x % ztiles) * kT;
    tile.lines = min(kT, nz - z0);
    if (AXIS == 0) {
      tile.base = static_cast<long long>(o) * nz + z0;
      tile.stride = static_cast<long long>(ny) * nz;
      tile.len = nx;
      fy = static_cast<float>(o);
    } else {
      tile.base = static_cast<long long>(o) * ny * nz + z0;
      tile.stride = nz;
      tile.len = ny;
      fx = static_cast<float>(o + xo);
    }
    fz = static_cast<float>(z0 + lane);
  } else {
    const long long c0 = static_cast<long long>(blockIdx.x) * kT;
    tile.lines = static_cast<int>(min(static_cast<long long>(kT), static_cast<long long>(nx) * ny - c0));
    tile.base = c0 * nz;
    tile.len = nz;
    const long long c = c0 + lane;
    fx = static_cast<float>(c / ny + xo);
    fy = static_cast<float>(c % ny);
  }
  const int chunks = (tile.len + kC - 1) / kC;

  if (warp > 0) {
    // Copiers: load chunk ch into buffer ch % 2 once the walker is done
    // with chunk ch - 2 there and that chunk is stored.
    const int w = warp - 1;
    // The inputs are only read; the cast serves the one copy routine.
    float* src_phi = const_cast<float*>(phi_in);
    float* src_cpos = const_cast<float*>(cpos_in);
    for (int ch = 0; ch < chunks + 2; ++ch) {
      const int b = ch & 1;
      if (ch >= 2) {
        const int t0 = (ch - 2) * kC;
        barrier_sync(kEmpty + b, kBlockThreads);
        move_chunk<AXIS, true>(bufs[b], phi_out, cpos_out, tile, t0, min(kC, tile.len - t0),
                               reverse, w, lane);
        barrier_sync(kCopied, kBlockThreads - 32);
      }
      if (ch < chunks) {
        const int t0 = ch * kC;
        move_chunk<AXIS, false>(bufs[b], src_phi, src_cpos, tile, t0, min(kC, tile.len - t0),
                                reverse, w, lane);
        wait_copies();
        barrier_arrive(kFull + b, kBlockThreads);
      }
    }
    return;
  }

  // The walker: one lane a line, the carried candidate in registers.
  const bool walks = lane < tile.lines;
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  for (int ch = 0; ch < chunks; ++ch) {
    const int b = ch & 1;
    const int t0 = ch * kC;
    const int nk = min(kC, tile.len - t0);
    barrier_sync(kFull + b, kBlockThreads);
    if (walks) {
      float* ph = bufs[b] + lane * kRow;
      float* px = ph + kField;
      float* py = ph + 2 * kField;
      float* pz = ph + 3 * kField;
      int k = 0;
      if (t0 == 0 && carry_in != nullptr) {
        // An x-slab's sweep continues a neighbour's: its first plane is
        // held against the carried candidate like any other.
        const long long j = 3 * (tile.base + lane);
        cx = carry_in[j];
        cy = carry_in[j + 1];
        cz = carry_in[j + 2];
      } else if (t0 == 0) {  // the sweep's first plane: copied, never updated
        cx = px[0];
        cy = py[0];
        cz = pz[0];
        k = 1;
      }
      float p = ph[k], ox = px[k], oy = py[k], oz = pz[k];
      for (; k < nk; ++k) {
        // Read the next slot before this one's chain.
        const int kn = k + 1 < nk ? k + 1 : k;
        const float pn = ph[kn], oxn = px[kn], oyn = py[kn], ozn = pz[kn];
        const int t = t0 + k;
        const float s = static_cast<float>(reverse ? tile.len - 1 - t : t);
        if (AXIS == 0) {
          fx = static_cast<float>((reverse ? tile.len - 1 - t : t) + xo);
        } else if (AXIS == 1) {
          fy = s;
        } else {
          fz = s;
        }
        const float d = fst::dist3(cx, cy, cz, fx, fy, fz) - r;
        if (d < p) {
          ph[k] = d;
          px[k] = cx;
          py[k] = cy;
          pz[k] = cz;
        } else {
          cx = ox;
          cy = oy;
          cz = oz;
        }
        p = pn;
        ox = oxn;
        oy = oyn;
        oz = ozn;
      }
    }
    barrier_arrive(kEmpty + b, kBlockThreads);
  }
  if (carry_out != nullptr && walks) {
    // The last plane's resulting candidate, for the next slab's sweep.
    const long long j = 3 * (tile.base + lane);
    carry_out[j] = cx;
    carry_out[j + 1] = cy;
    carry_out[j + 2] = cz;
  }
}

}  // namespace

// Run the sweeps codes[0..ncodes) in order (code: 0 Xm, 1 Xp, 2 Ym, 3 Yp,
// 4 Zm, 5 Zp; axis code / 2, reversed when odd). codes is a host array.
// x0: the grid's first x plane is plane x0 of the domain, whose frame the
// candidates are in (a rank's x-slab, parallel/halo_step.py); the distances
// are to the centres x0 + x. 0 for a whole grid.
extern "C" int fst_sweeps(const float* phi_in, const float* cpos_in, float* phi_out,
                          float* cpos_out, int nx, int ny, int nz, float r,
                          const int* codes, int ncodes, int x0, void* stream) {
  if (ncodes < 1 || nx < 1 || ny < 1 || nz < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < ncodes; ++i) {
    if (codes[i] < 0 || codes[i] > 5) return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long ztiles = (nz + kT - 1) / kT;
  const long long tiles[3] = {ny * ztiles, nx * ztiles,
                              (static_cast<long long>(nx) * ny + kT - 1) / kT};
  for (long long n : tiles) {
    if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < ncodes; ++i) {
    const int axis = codes[i] / 2;
    const int reverse = codes[i] & 1;
    const float* src_phi = i == 0 ? phi_in : phi_out;
    const float* src_cpos = i == 0 ? cpos_in : cpos_out;
    const unsigned int grid = static_cast<unsigned int>(tiles[axis]);
    if (axis == 0) {
      sweep_tile_kernel<0><<<grid, kBlockThreads, 0, s>>>(src_phi, src_cpos, phi_out, cpos_out, nullptr, nullptr, nx, ny, nz, reverse, r, x0);
    } else if (axis == 1) {
      sweep_tile_kernel<1><<<grid, kBlockThreads, 0, s>>>(src_phi, src_cpos, phi_out, cpos_out, nullptr, nullptr, nx, ny, nz, reverse, r, x0);
    } else {
      sweep_tile_kernel<2><<<grid, kBlockThreads, 0, s>>>(src_phi, src_cpos, phi_out, cpos_out, nullptr, nullptr, nx, ny, nz, reverse, r, x0);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// One x-sweep of an x-slab (parallel/halo_step.py's relay), continuing the
// sweep of the slab before it (after it when reversed): plane 0 (plane
// nx - 1 when reversed) is held against carry_in, the (ny, nz, 3)
// candidate plane the neighbouring slab's sweep ended with, already moved
// into this slab's frame. carry_in null: the first plane is copied, as in
// fst_sweeps (the slab at the domain's edge). carry_out, if not null,
// receives the (ny, nz, 3) candidates of the last plane walked, for the
// next slab. x0 as in fst_sweeps. The same kernel as fst_sweeps' x-sweeps, with the carry
// read and written by the walking lane: 24 B a line more, so the same
// bound (the slab's phi and cpos read and written once). Carry pointers
// rather than the received plane prepended to the slab: the kernel
// measures distances to the centres at its plane indices, so a prepended
// plane would move every centre by one, and it would cost a copy of the
// slab a sweep.
extern "C" int fst_sweep_x_carry(const float* phi_in, const float* cpos_in, float* phi_out,
                                 float* cpos_out, const float* carry_in, float* carry_out,
                                 int nx, int ny, int nz, int reverse, float r, int x0,
                                 void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || (reverse != 0 && reverse != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = static_cast<long long>(ny) * ((nz + kT - 1) / kT);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sweep_tile_kernel<0><<<static_cast<unsigned int>(tiles), kBlockThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      phi_in, cpos_in, phi_out, cpos_out, carry_in, carry_out, nx, ny, nz, reverse, r, x0);
  return static_cast<int>(cudaGetLastError());
}

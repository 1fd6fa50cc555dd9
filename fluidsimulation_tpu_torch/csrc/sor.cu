// Checkerboard SOR pressure solve: the whole solve on the caller's stream,
// as one list-building launch and one persistent cooperative launch.
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
// -fmad=false and IEEE division, the kernel matches it bit for bit. Air
// cells keep p = 0.
//
// Bound on the H100: the function reads phi, diag and b and writes p once,
// 16 B a cell (34 MB at 128^3, ~10 us at 3.35 TB/s), and does 11 flops
// per fluid cell per iteration. What holds it back is the chain of 200
// dependent half-updates. Each moves ~36 B a listed cell through L1/L2 (a
// 16 B record, the own p and six neighbours, a store), ~10 MB at 128^3
// with ~270,000 fluid cells a colour: one to two microseconds, the same
// order as what separates two half-updates: a kernel launch (~7 us with
// the launch gap), or a grid barrier (~1.1-1.5 us, 199 of them a solve).
// Design:
//   1. Prologue: zero p and the scratch (memsets), then one launch builds
//      two compact lists, one per colour, of the fluid cells only. An
//      entry is one 16 B record {index in the colour-split layout below,
//      6-bit neighbour-fluid mask, z parity, b, diag}, so one int4 load
//      brings a cell's own state; air cells take no thread. Entries are
//      appended with a warp-aggregated atomicAdd on the colour's counter,
//      so the list's order varies from run to run. That changes no
//      result: the cells of one colour are independent within a
//      half-update (each neighbour has the other colour), so every cell
//      sees the same values whatever order they run in.
//   2. p lives split by colour during the solve (layout below): a warp's
//      32 list entries are mostly 32 consecutive cells of one colour, and
//      their own values and their six neighbours (of the other colour) are
//      then 7 contiguous runs. In the natural layout every sector read
//      would be half of the colour not needed.
//   3. One cooperative launch runs all the iterations: colour 0, grid
//      barrier, colour 1, grid barrier, ... (2 x iterations - 1 barriers,
//      cooperative_groups' grid sync). Each half-update grid-strides over
//      its colour's list; the counts are read from device memory, so the
//      host never waits. The other colour's half is only read during a
//      half-update, so its loads go through L1: the grid barrier's fences
//      order them after the stores of the half-update before (CUDA's
//      memory model), and neighbouring rows of one block share lines
//      (faster than reads through L2 alone at each size tried). The own value
//      is read through L2 (__ldcg). The last iteration also writes each
//      cell's value to the natural layout (zeroed first, so air cells keep
//      0). The grid is the most blocks the card holds at once (kSorThreads
//      = 1024 a block, two an SM: 264 on 132 SMs; one block an SM was
//      slower), fewer when a colour's worst-case list is shorter. A refused
//      launch returns its error; there is no other path.
// The wrapper allocates the scratch: the lists and the split p (each of
// 2 x nx*ny*ceil(nz/2) entries) and three counters (the two colours'
// fluid cells and the barriers run).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// Neighbour-fluid bits, in the order of the sum; then the cell's z parity.
constexpr int kXm = 1, kXp = 2, kYm = 4, kYp = 8, kZm = 16, kZp = 32, kOddZ = 64;
constexpr int kSorThreads = 1024;

// The colour-split layout: cell (x, y, z) of colour c = (x + y + z) % 2
// sits at pc[c * half + (x * ny + y) * hz + z / 2], hz = ceil(nz / 2),
// half = nx * ny * hz. Its x, y neighbours (colour 1 - c) sit at the same
// offset +- ny * hz, +- hz in the other colour's half, its z neighbours at
// (z -+ 1) / 2, that is z / 2 - 1 + (z odd) and z / 2 + (z odd).

// Thread t takes compact slot t % half of colour t / half; a fluid cell
// there appends its record to its colour's list.
__global__ void sor_list_kernel(const float* __restrict__ phi,
                                const float* __restrict__ diag,
                                const float* __restrict__ b,
                                int4* __restrict__ list0, int4* __restrict__ list1,
                                int* __restrict__ counters, int nx, int ny, int nz) {
  const int hz = (nz + 1) / 2;
  const long long half = static_cast<long long>(nx) * ny * hz;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  // Every lane of the warp takes part in the ballots below.
  bool fluid = false;
  int color = 0;
  int4 rec = make_int4(0, 0, 0, 0);
  if (t < 2 * half) {
    color = static_cast<int>(t / half);
    const int q = static_cast<int>(t - color * half);
    const int row = q / hz;
    const int x = row / ny;
    const int y = row - x * ny;
    const int z = 2 * (q - row * hz) + ((x + y + color) & 1);
    const long long c = static_cast<long long>(row) * nz + z;
    fluid = z < nz && phi[c] < 0.0f;
    if (fluid) {
      const long long sx = static_cast<long long>(ny) * nz;
      const long long sy = nz;
      int m = (z & 1) ? kOddZ : 0;
      if (x > 0 && phi[c - sx] < 0.0f) m |= kXm;
      if (x < nx - 1 && phi[c + sx] < 0.0f) m |= kXp;
      if (y > 0 && phi[c - sy] < 0.0f) m |= kYm;
      if (y < ny - 1 && phi[c + sy] < 0.0f) m |= kYp;
      if (z > 0 && phi[c - 1] < 0.0f) m |= kZm;
      if (z < nz - 1 && phi[c + 1] < 0.0f) m |= kZp;
      rec = make_int4(q, m, __float_as_int(b[c]), __float_as_int(diag[c]));
    }
  }
  const unsigned lane = threadIdx.x & 31u;
  for (int c = 0; c < 2; ++c) {
    const bool mine = fluid && color == c;
    const unsigned want = __ballot_sync(0xffffffffu, mine);
    if (want == 0) continue;
    const int leader = __ffs(static_cast<int>(want)) - 1;
    int base = 0;
    if (static_cast<int>(lane) == leader) base = atomicAdd(&counters[c], __popc(want));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (mine) (c ? list1 : list0)[base + __popc(want & ((1u << lane) - 1u))] = rec;
  }
}

__global__ void __launch_bounds__(kSorThreads, 2)
sor_persistent_kernel(float* p, float* pc, const int4* __restrict__ list0,
                      const int4* __restrict__ list1, int* counters, int nx, int ny,
                      int nz, int iterations, float omega, float one_minus_omega) {
  cg::grid_group grid = cg::this_grid();
  const int hz = (nz + 1) / 2;
  const int half = nx * ny * hz;
  const int sx = ny * hz;
  const int count0 = counters[0];
  const int count1 = counters[1];
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int step = gridDim.x * blockDim.x;
  for (int it = 0; it < iterations; ++it) {
    const bool last = it + 1 == iterations;
    for (int c = 0; c < 2; ++c) {
      const int4* list = c ? list1 : list0;
      const int count = c ? count1 : count0;
      float* own = pc + c * half;
      const float* other = pc + (1 - c) * half;
      for (int i = first; i < count; i += step) {
        const int4 rec = __ldg(list + i);
        const int q = rec.x;
        const int m = rec.y;
        const int odd = (m & kOddZ) ? 1 : 0;
        float nms = 0.0f;
        nms = nms - ((m & kXm) ? other[q - sx] : 0.0f);
        nms = nms - ((m & kXp) ? other[q + sx] : 0.0f);
        nms = nms - ((m & kYm) ? other[q - hz] : 0.0f);
        nms = nms - ((m & kYp) ? other[q + hz] : 0.0f);
        nms = nms - ((m & kZm) ? other[q - 1 + odd] : 0.0f);
        nms = nms - ((m & kZp) ? other[q + odd] : 0.0f);
        const float v = one_minus_omega * __ldcg(own + q) +
                        (omega * (__int_as_float(rec.z) - nms)) / __int_as_float(rec.w);
        own[q] = v;
        if (last) {
          // The cell's final value, to the natural layout.
          const int row = q / hz;
          p[row * nz + 2 * (q - row * hz) + odd] = v;
        }
      }
      if (c == 0 || !last) {
        grid.sync();
        if (first == 0) ++counters[2];
      }
    }
  }
}

}  // namespace

// lists: 2 x half int4 and pc: 2 x half floats, half = nx*ny*ceil(nz/2);
// counters: 3 ints.
extern "C" int fst_sor(const float* phi, const float* diag, const float* b,
                       float* p, int4* lists, float* pc, int* counters, int nx, int ny,
                       int nz, int iterations, float omega, float one_minus_omega,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ncell = static_cast<long long>(nx) * ny * nz;
  const long long half = static_cast<long long>(nx) * ny * ((nz + 1) / 2);
  if (nx < 1 || ny < 1 || nz < 1 || 2 * half > 0x7fffffffLL || iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(p, 0, ncell * sizeof(float), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(pc, 0, 2 * half * sizeof(float), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(counters, 0, 3 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  sor_list_kernel<<<fst::blocks_for(2 * half), fst::kThreads, 0, s>>>(
      phi, diag, b, lists, lists + half, counters, nx, ny, nz);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sor_persistent_kernel, kSorThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long need = (half + kSorThreads - 1) / kSorThreads;
  const long long most = static_cast<long long>(per_sm) * sms;
  const unsigned int blocks = static_cast<unsigned int>(need < most ? need : most);
  int4* list0 = lists;
  int4* list1 = lists + half;
  void* args[] = {&p, &pc, &list0, &list1, &counters, &nx, &ny, &nz,
                  &iterations, &omega, &one_minus_omega};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sor_persistent_kernel),
                                    dim3(blocks), dim3(kSorThreads), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One colour's half-update of the SOR on an x-slab: the halo solve of
// parallel/halo.py, where the ranks exchange p's boundary planes between
// two half-updates, which fst_sor's one cooperative launch cannot do.
// It replaces no TPU kernel of its own: the JAX package runs this solve
// (parallel/halo.py::_sor_local) as XLA ops under shard_map, and its
// Pallas SOR (ops/pallas_sor.py::_sor_kernel) is the one-device solve,
// which fst_sor stays.
//
// The slab holds global x planes x0 .. x0 + sx - 1 of the grid; p_lo and
// p_hi are the (ny, nz) planes of p next to it (x0 - 1 and x0 + sx), and
// phi_lo, phi_hi those of phi (0 outside the domain: not fluid). A fluid
// cell of colour (x0 + x + y + z) % 2 == color takes, in place,
//   nms = +0 - p[x-1] - p[x+1] - p[y-1] - p[y+1] - p[z-1] - p[z+1]
//   p   = (1 - omega) * p + (omega * (b - nms)) / diag
// with fst_sor's neighbour rule and operation order, so that 200 launches
// with the exchanges between them give fst_sor's p bit for bit. In place
// is safe: a cell of one colour reads only cells of the other.
//
// Bound on the H100: a launch reads p, phi, diag and b and writes p for
// the cells of its colour, ~10 B a cell of the slab (1.3 MB for a
// 32 x 128 x 128 slab, 0.4 us at 3.35 TB/s); at these sizes the launch
// itself (a few us) and the exchange between two launches cost more.
// Design: the simplest that is right. One thread a cell of the colour
// (threads walk the colour's cells of a row, z stepping by 2), no shared
// memory, no list: each launch reads phi again to find the fluid cells.
namespace {

__global__ void sor_half_kernel(float* __restrict__ p, const float* __restrict__ p_lo,
                                const float* __restrict__ p_hi,
                                const float* __restrict__ phi,
                                const float* __restrict__ phi_lo,
                                const float* __restrict__ phi_hi,
                                const float* __restrict__ diag,
                                const float* __restrict__ b, int sx, int ny, int nz,
                                int x0, int color, float omega, float one_minus_omega) {
  const int hz = (nz + 1) / 2;
  const long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (q >= static_cast<long long>(sx) * ny * hz) return;
  const long long row = q / hz;
  const int x = static_cast<int>(row / ny);
  const int y = static_cast<int>(row - static_cast<long long>(x) * ny);
  // (x0 + x + y + z) % 2 == color fixes z's parity.
  const int z = 2 * static_cast<int>(q - row * hz) + ((x0 + x + y + color) & 1);
  if (z >= nz) return;
  const long long c = row * nz + z;
  if (!(phi[c] < 0.0f)) return;
  const long long sxs = static_cast<long long>(ny) * nz;
  const long long j = static_cast<long long>(y) * nz + z;  // in an x-plane
  float xm, xp;
  if (x > 0) {
    xm = phi[c - sxs] < 0.0f ? p[c - sxs] : 0.0f;
  } else {
    xm = phi_lo[j] < 0.0f ? p_lo[j] : 0.0f;
  }
  if (x < sx - 1) {
    xp = phi[c + sxs] < 0.0f ? p[c + sxs] : 0.0f;
  } else {
    xp = phi_hi[j] < 0.0f ? p_hi[j] : 0.0f;
  }
  float nms = 0.0f;
  nms = nms - xm;
  nms = nms - xp;
  nms = nms - ((y > 0 && phi[c - nz] < 0.0f) ? p[c - nz] : 0.0f);
  nms = nms - ((y < ny - 1 && phi[c + nz] < 0.0f) ? p[c + nz] : 0.0f);
  nms = nms - ((z > 0 && phi[c - 1] < 0.0f) ? p[c - 1] : 0.0f);
  nms = nms - ((z < nz - 1 && phi[c + 1] < 0.0f) ? p[c + 1] : 0.0f);
  p[c] = one_minus_omega * p[c] + (omega * (b[c] - nms)) / diag[c];
}

}  // namespace

extern "C" int fst_sor_half(float* p, const float* p_lo, const float* p_hi, const float* phi,
                            const float* phi_lo, const float* phi_hi, const float* diag,
                            const float* b, int sx, int ny, int nz, int x0, int color,
                            float omega, float one_minus_omega, void* stream) {
  if (sx < 1 || ny < 1 || nz < 1 || x0 < 0 || (color != 0 && color != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(sx) * ny * ((nz + 1) / 2);
  if ((n + fst::kThreads - 1) / fst::kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sor_half_kernel<<<fst::blocks_for(n), fst::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, p_lo, p_hi, phi, phi_lo, phi_hi, diag, b, sx, ny, nz, x0, color, omega,
      one_minus_omega);
  return static_cast<int>(cudaGetLastError());
}

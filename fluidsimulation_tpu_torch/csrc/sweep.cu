// One directional fast sweep of the level set's closest-candidate field.
//
// Replaces fluidsimulation_tpu/ops/pallas_sweep.py::_sweep_kernel (driven
// by _sweep_major and sweep_closest_pallas), the TPU form of
// ops/levelset.py::_sweep_axis and of gpClosestParticlesSweep{X,Y,Z}{m,p}.
// Along each line of the swept axis the thread carries the previous
// plane's resulting candidate; a cell takes the carried candidate when it
// is strictly closer than the cell's own phi, and the carry becomes the
// cell's resulting candidate. The first plane of the sweep (plane n-1 when
// reversed) is copied and never updated. The wrapper launches this 24 times
// per step in SWEEP_ORDER: each sweep must see the whole result of the one
// before, so sweeps cannot share a launch.
//
// Bound on the H100: latency of the serial line walk. A launch at 128^3
// has 16,384 threads (about 0.1 of the card's resident-thread capacity),
// each walking 128 dependent steps of a load, a sqrt and a store; the
// 4 fields are 34 MB, so one pass of DRAM traffic would take only ~20 us.
// Design: one thread per line, working on the [x, y, z] layout directly
// (the JAX transposes that put the swept axis first are a TPU layout
// choice). Lines along x and y put z across the warp, so loads coalesce;
// lines along z stride by nz across the warp and do not, which is
// accepted in this first version. Working in place is safe: a thread reads
// and writes only its own line, and reads each cell before writing it.
//
// Compile with -fmad=false (see seed.cu): the strict `<` must see the same
// distance as the plain version.
#include "common.cuh"

namespace {

__global__ void sweep_kernel(const float* phi_in, const float* cpos_in,
                             float* phi_out, float* cpos_out, int nx, int ny,
                             int nz, int axis, int reverse, float r) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  int x = 0, y = 0, z = 0, len = 0;
  long long stride = 0;
  if (axis == 0) {
    if (t >= static_cast<long long>(ny) * nz) return;
    y = static_cast<int>(t / nz);
    z = static_cast<int>(t % nz);
    len = nx;
    stride = static_cast<long long>(ny) * nz;
  } else if (axis == 1) {
    if (t >= static_cast<long long>(nx) * nz) return;
    x = static_cast<int>(t / nz);
    z = static_cast<int>(t % nz);
    len = ny;
    stride = nz;
  } else {
    if (t >= static_cast<long long>(nx) * ny) return;
    x = static_cast<int>(t / ny);
    y = static_cast<int>(t % ny);
    len = nz;
    stride = 1;
  }
  const long long base = (static_cast<long long>(x) * ny + y) * nz + z;
  const int s0 = reverse ? len - 1 : 0;
  const int step = reverse ? -1 : 1;

  long long e = base + s0 * stride;
  float cx = cpos_in[3 * e + 0];
  float cy = cpos_in[3 * e + 1];
  float cz = cpos_in[3 * e + 2];
  phi_out[e] = phi_in[e];
  cpos_out[3 * e + 0] = cx;
  cpos_out[3 * e + 1] = cy;
  cpos_out[3 * e + 2] = cz;

  float fx = static_cast<float>(x);
  float fy = static_cast<float>(y);
  float fz = static_cast<float>(z);
  for (int k = 1; k < len; ++k) {
    const int s = s0 + k * step;
    e = base + s * stride;
    if (axis == 0) {
      fx = static_cast<float>(s);
    } else if (axis == 1) {
      fy = static_cast<float>(s);
    } else {
      fz = static_cast<float>(s);
    }
    const float p = phi_in[e];
    const float ox = cpos_in[3 * e + 0];
    const float oy = cpos_in[3 * e + 1];
    const float oz = cpos_in[3 * e + 2];
    const float d = fst::dist3(cx, cy, cz, fx, fy, fz) - r;
    if (d < p) {
      phi_out[e] = d;
    } else {
      phi_out[e] = p;
      cx = ox;
      cy = oy;
      cz = oz;
    }
    cpos_out[3 * e + 0] = cx;
    cpos_out[3 * e + 1] = cy;
    cpos_out[3 * e + 2] = cz;
  }
}

}  // namespace

extern "C" int fst_sweep(const float* phi_in, const float* cpos_in,
                         float* phi_out, float* cpos_out, int nx, int ny,
                         int nz, int axis, int reverse, float r, void* stream) {
  long long lines = 0;
  if (axis == 0) {
    lines = static_cast<long long>(ny) * nz;
  } else if (axis == 1) {
    lines = static_cast<long long>(nx) * nz;
  } else if (axis == 2) {
    lines = static_cast<long long>(nx) * ny;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (lines > 0 && (axis == 0 ? nx : axis == 1 ? ny : nz) > 0) {
    sweep_kernel<<<fst::blocks_for(lines), fst::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        phi_in, cpos_in, phi_out, cpos_out, nx, ny, nz, axis, reverse, r);
  }
  return static_cast<int>(cudaGetLastError());
}

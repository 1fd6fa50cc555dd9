// Shared by the kernel sources: launch geometry and the C-interface rule.
//
// Every entry point is `extern "C"`, takes raw device pointers and the
// caller's cudaStream_t (PyTorch's current stream), launches without
// synchronising, allocates nothing, and returns cudaGetLastError() so that
// a refused launch is reported to the Python wrapper.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace fst {

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// Candidate coordinate of a cell with no particle (ops/levelset.py FAR).
constexpr float kFar = 1.0e9f;

// Squared-distance sum in x, y, z order, as the plain versions compute it.
// Compiled with -fmad=false, so each product and sum rounds separately.
__device__ __forceinline__ float dist3(float ax, float ay, float az,
                                       float bx, float by, float bz) {
  const float ex = ax - bx;
  const float ey = ay - by;
  const float ez = az - bz;
  return sqrtf(ex * ex + ey * ey + ez * ez);
}

// -- MAC-grid interpolation with core/interp.py's semantics ------------------
// Shared by the FLIP gather (g2p.cu) and the RK3 gather (interp.cu). With
// -fmad=false each lerp is a separate product and sum, the plain version's
// rounding, so both kernels equal core/interp.py::interp_mac3 bit for bit.

struct Split {
  int i;
  float f;
};

// The NaN rule (core/interp.py): fmaxf maps a NaN coordinate to the lower
// bound, which keeps the index in range; the fraction takes the NaN back, as
// the plain version's clamp keeps it, so every lerp of the particle is NaN.
// A finite coordinate is untouched.
__device__ __forceinline__ float keep_nan(float coord, float frac) {
  return isnan(coord) ? coord : frac;
}

// Clamp to [0, m-1]; floor, but at most m-2 (Simulation3D.h:61,70).
__device__ __forceinline__ Split split_normal(float coord, int m) {
  const float n = fminf(fmaxf(coord, 0.0f), static_cast<float>(m) - 1.0f);
  const float i = fminf(floorf(n), static_cast<float>(m) - 2.0f);
  return {static_cast<int>(i), keep_nan(coord, n - i)};
}

// Clamp coord+0.5 to [0, m]; floor, but at most m-1 (Simulation3D.h:65,73).
__device__ __forceinline__ Split split_extended(float coord, int m) {
  const float c = coord + 0.5f;
  const float e = fminf(fmaxf(c, 0.0f), static_cast<float>(m));
  const float i = fminf(floorf(e), static_cast<float>(m) - 1.0f);
  return {static_cast<int>(i), keep_nan(c, e - i)};
}

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return a + (b - a) * t;
}

// Trilinear interpolation of 8 corner values c[(z * 2 + y) * 2 + x], in the
// lerp order of core/interp.py::_trilerp.
__device__ __forceinline__ float trilerp(const float (&c)[8], Split x, Split y, Split z) {
  const float t00 = lerp(c[0], c[1], x.f);
  const float t10 = lerp(c[2], c[3], x.f);
  const float t01 = lerp(c[4], c[5], x.f);
  const float t11 = lerp(c[6], c[7], x.f);
  const float tx0 = lerp(t00, t10, y.f);
  const float tx1 = lerp(t01, t11, y.f);
  return lerp(tx0, tx1, z.f);
}

}  // namespace fst

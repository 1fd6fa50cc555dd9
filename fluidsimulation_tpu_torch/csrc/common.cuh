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

}  // namespace fst

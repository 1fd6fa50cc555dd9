// Error text for the codes the entry points return.
#include <cuda_runtime.h>

extern "C" const char* fst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

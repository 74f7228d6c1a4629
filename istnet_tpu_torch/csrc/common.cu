// Shared C entry points of libistnet_kernels.so.
#include <cuda_runtime.h>

extern "C" const char* istnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

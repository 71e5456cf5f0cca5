// Error text for the codes the other entries return (cudaGetLastError()).

#include <cuda_runtime.h>

extern "C" const char* csgn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

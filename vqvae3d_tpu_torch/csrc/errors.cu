// Error strings for the C entry points' return codes (cudaError_t values).
#include <cuda_runtime.h>

extern "C" const char* vq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

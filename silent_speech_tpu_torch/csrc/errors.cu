// The message for a cudaError_t returned by one of the library's launch
// functions (the Python wrappers raise with it).

#include <cuda_runtime.h>

extern "C" const char* sst_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

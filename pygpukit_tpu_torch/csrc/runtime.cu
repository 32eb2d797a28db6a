// Error names for the Python wrappers' exceptions.
#include "common.cuh"

PGK_API const char* pgk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

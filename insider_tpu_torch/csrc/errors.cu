// Error text for the codes the entry points return.
#include "common.cuh"

INSIDER_API const char* insider_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

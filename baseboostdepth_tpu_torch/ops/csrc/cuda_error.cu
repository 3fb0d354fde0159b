// The message of a cudaError_t returned by a launcher, for the Python
// wrappers' exceptions. Every library of the port links this file once.

#include <cuda_runtime.h>

extern "C" const char* bbd_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

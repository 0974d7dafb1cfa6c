// Second pass of the weight-gradient kernels (subm_conv_dw.cu,
// subm_conv_dw_wgmma.cu): dW = the per-chunk partials added in chunk order,
// one thread per entry, so the sum is the same bit for bit from run to run.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void dw_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ dw, int n_chunks,
                                 int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += partial[(int64_t)c * n + i];
  dw[i] = s;
}

// partial (n_chunks, n) float32 -> dw (n,) on `stream`
inline int launch_dw_reduce(const void* partial, void* dw, int n_chunks,
                            int64_t n, cudaStream_t stream) {
  const int threads = 256;
  dw_reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                     stream>>>((const float*)partial, (float*)dw, n_chunks,
                               n);
  return (int)cudaGetLastError();
}

}  // namespace

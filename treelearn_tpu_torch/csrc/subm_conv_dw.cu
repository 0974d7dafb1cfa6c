// Weight gradient of the submanifold sparse convolution on the float32
// SIMT units, the first dW kernel of the port: the yardstick the
// tensor-core dW kernels are timed against (see the end of this header).
//
// Replaces the Pallas kernel _dw_kernel / rule_conv_dw_banded
// (treelearn_tpu/ops/pallas_conv.py:415,438).  The TPU grid runs its tiles
// in order and adds each tile's (27 Cin, Cout) outer-product GEMM into one
// VMEM-resident accumulator (out_ref, pallas_conv.py:419-430).  Blocks of a
// GPU run in parallel and in no order, so the sum over the V rows crosses
// blocks, and this kernel takes the deterministic two-pass form:
//
//   pass 1: the rows are cut into n_chunks equal chunks; block
//           (tile, k, chunk), k one of the K kernel offsets (27 for
//           kernel_size 3, k^3 for any odd k; an argument), gathers, 32
//           rows at a time, x[rule[k, i]] (a 64-channel slice of Cin) and
//           g[i] (a 64-channel slice of Cout)
//           into shared memory and every thread sums a 4 x 4 block of
//           outer products in float32 registers; the block writes its
//           64 x 64 tile to partial[chunk, k];
//   pass 2: dW[k, c, n] = sum over chunks, in chunk order (dw_reduce.cuh).
//
//   dW[k] = sum_i x[rule[k, i]]^T g[i]      (rule -1: no input)
//
// No atomics: every partial sum is taken in a fixed order, so dW is the same
// bit for bit from run to run.  The wrapper (ops/subm_conv.py) picks
// n_chunks so that the partials stay under 64 MiB (one (27, 224, 224) float32
// slab is 5.4 MB) while enough blocks are in flight to fill the card.
// x and g are float32 or bfloat16 (the working type); products are formed
// and summed in float32, as the Pallas kernel's preferred_element_type does.
//
// Bound on the card: operations (2 Cin Cout per rule entry against Cin +
// Cout values moved per row).  The products run on the float32 SIMT units
// (bf16 inputs are widened in shared memory), a block owns one (offset,
// 64 x 64 channel tile, row chunk) and so reads g again for each of the K
// offsets and x again for each Cout tile, and no copy is in flight during
// the products: about 9 TFLOP/s on bf16 inputs.  The tensor-core kernels
// exist for that reason (csrc/subm_conv_dw_wgmma.cu in bf16,
// csrc/subm_conv_dw_tf32.cu in float32, any offset count, odd widths
// zero-padded onto them): ops/subm_conv.py routes this kernel nothing in the
// shipped paths, and it stays as their yardstick (subm_conv_dw_simt).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include "dw_reduce.cuh"

namespace {

constexpr int TC = 64;   // input channels per block
constexpr int TN = 64;   // output channels per block
constexpr int TR = 32;   // rows per shared-memory stage
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  const int32_t* __restrict__ rule, float* __restrict__ partial,
                  int v, int cin, int cout, int n_offsets,
                  int rows_per_chunk, int tiles_n) {
  __shared__ float Xs[TR][TC];
  __shared__ float Gs[TR][TN];
  __shared__ int idx_s[TR];

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // output-channel group
  const int ty = tid / 16;   // input-channel group
  const int c0 = (blockIdx.x / tiles_n) * TC;
  const int n0 = (blockIdx.x % tiles_n) * TN;
  const int k = blockIdx.y;
  const int chunk = blockIdx.z;
  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(v, row_begin + rows_per_chunk);

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int r0 = row_begin; r0 < row_end; r0 += TR) {
    int my = -1;
    if (tid < TR) {
      const int row = r0 + tid;
      if (row < row_end) my = rule[(int64_t)k * v + row];
      idx_s[tid] = my;
    }
    // also orders idx_s before its readers below
    if (!__syncthreads_or(my >= 0)) continue;
    for (int e = tid; e < TR * TC; e += THREADS) {
      const int r = e / TC;
      const int c = e % TC;
      const int src = idx_s[r];
      float val = 0.f;
      if (src >= 0 && c0 + c < cin)
        val = to_f32(x[(int64_t)src * cin + c0 + c]);
      Xs[r][c] = val;
    }
    for (int e = tid; e < TR * TN; e += THREADS) {
      const int r = e / TN;
      const int n = e % TN;
      float val = 0.f;
      if (idx_s[r] >= 0 && n0 + n < cout)
        val = to_f32(g[(int64_t)(r0 + r) * cout + n0 + n]);
      Gs[r][n] = val;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < TR; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = Xs[r][ty * 4 + q];
        b[q] = Gs[r][tx * 4 + q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] += a[p] * b[q];
    }
    __syncthreads();
  }

  float* out = partial + ((int64_t)chunk * n_offsets + k) * cin * cout;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int c = c0 + ty * 4 + p;
    if (c >= cin) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      if (n < cout) out[(int64_t)c * cout + n] = acc[p][q];
    }
  }
}

template <typename T>
int launch(const void* x, const void* g, const void* rule, void* partial,
           void* dw, int v, int cin, int cout, int n_offsets, int n_chunks,
           void* stream) {
  const int tiles_c = (cin + TC - 1) / TC;
  const int tiles_n = (cout + TN - 1) / TN;
  const int rows_per_chunk = (v + n_chunks - 1) / n_chunks;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(tiles_c * tiles_n, n_offsets, n_chunks);
  dw_partial_kernel<T><<<grid, THREADS, 0, s>>>(
      (const T*)x, (const T*)g, (const int32_t*)rule, (float*)partial, v,
      cin, cout, n_offsets, rows_per_chunk, tiles_n);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_dw_reduce(partial, dw, n_chunks,
                          (int64_t)n_offsets * cin * cout, s);
}

}  // namespace

// x (v, cin), g (v, cout) in one type, rule (n_offsets, v) int32, partial
// (n_chunks, n_offsets, cin, cout) float32 scratch, dw (n_offsets, cin,
// cout) float32.
extern "C" int tl_subm_conv_dw_f32(const void* x, const void* g,
                                   const void* rule, void* partial, void* dw,
                                   int v, int cin, int cout, int n_offsets,
                                   int n_chunks, void* stream) {
  return launch<float>(x, g, rule, partial, dw, v, cin, cout, n_offsets,
                       n_chunks, stream);
}

extern "C" int tl_subm_conv_dw_bf16(const void* x, const void* g,
                                    const void* rule, void* partial, void* dw,
                                    int v, int cin, int cout, int n_offsets,
                                    int n_chunks, void* stream) {
  return launch<__nv_bfloat16>(x, g, rule, partial, dw, v, cin, cout,
                               n_offsets, n_chunks, stream);
}

// Submanifold sparse convolution as a gather-GEMM on the float32 SIMT units,
// the first kernel of the port.  ops/subm_conv.py routes it nothing in the
// shipped paths: every conv of either dtype at up to 343 offsets goes to the
// tensor-core kernels (csrc/subm_conv_wgmma.cu in bf16,
// csrc/subm_conv_tf32.cu in float32, odd widths zero-padded onto them), and
// only K > 343 would land here.  It stays as the yardstick both are timed
// against (subm_conv_simt).
//
// Replaces the Pallas kernel _subm_kernel + _gather_bands
// (treelearn_tpu/ops/pallas_conv.py:304,181).  The TPU kernel DMAs banded
// windows of the sorted features and selects rows with one-hot MXU
// products because the TPU gathers slowly; a GPU gathers rows directly, so
// here a block owns a tile of 64 output voxels x 64 output channels and, for
// each of the K offsets (27 for kernel_size 3, k^3 for any odd k: the
// offset count is an argument, and shared memory holds one offset at a
// time, so nothing here is sized by it), gathers feats[rule[k, i]] rows of
// a 32-channel slice into shared memory next to the matching 32 x 64 slice
// of W[k], and
// every thread accumulates a 4 x 4 block of outputs in float32 registers.
// Offsets that no voxel of the tile uses are skipped (__syncthreads_or).
//
//   out[i] = sum_k feats[rule[k, i]] @ W[k]      (rule -1: no input)
//   rows i >= n_live are written as zeros
//
// Inputs are float32 or bfloat16 (W in the same type as feats); products are
// summed in float32 and written back in the input type, as the Pallas kernel
// does (pallas_conv.py:317-323).
//
// Bound: operations, at the float32 rate of the SIMT units (the tensor
// cores take no float32 operands without rounding them to TF32, which the
// float32 parity checks could not bear).  At the narrow input conv (4 -> 32)
// it moves more bytes than it multiplies: there the bound is memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;   // output voxels per block
constexpr int TN = 64;   // output channels per block
constexpr int TK = 32;   // input channels per shared-memory stage
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
subm_conv_kernel(const T* __restrict__ feats, const T* __restrict__ weight,
                 const int32_t* __restrict__ rule, T* __restrict__ out,
                 int v_out, int n_live, int cin, int cout, int n_offsets) {
  __shared__ float As[TK][TM + 1];  // gathered features, channel-major
  __shared__ float Bs[TK][TN];      // weight slice
  __shared__ int idx_s[TM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;          // output-channel group
  const int ty = tid / 16;          // output-row group
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * TN;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int k = 0; k < n_offsets; ++k) {
    int my = -1;
    if (tid < TM) {
      const int row = row0 + tid;
      if (row < v_out && row < n_live) my = rule[(int64_t)k * v_out + row];
      idx_s[tid] = my;
    }
    // also orders idx_s before its readers below
    if (!__syncthreads_or(my >= 0)) continue;

    for (int c0 = 0; c0 < cin; c0 += TK) {
      // gather: TM rows x TK channels, consecutive threads on consecutive
      // channels of one row
      for (int e = tid; e < TM * TK; e += THREADS) {
        const int r = e / TK;
        const int c = e % TK;
        const int src = idx_s[r];
        float v = 0.f;
        if (src >= 0 && c0 + c < cin)
          v = to_f32(feats[(int64_t)src * cin + c0 + c]);
        As[c][r] = v;
      }
      for (int e = tid; e < TK * TN; e += THREADS) {
        const int c = e / TN;
        const int n = e % TN;
        float w = 0.f;
        if (c0 + c < cin && col0 + n < cout)
          w = to_f32(weight[((int64_t)k * cin + c0 + c) * cout + col0 + n]);
        Bs[c][n] = w;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < TK; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = As[c][ty * 4 + q];
          b[q] = Bs[c][tx * 4 + q];
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] += a[p] * b[q];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int row = row0 + ty * 4 + p;
    if (row >= v_out) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = col0 + tx * 4 + q;
      if (col >= cout) continue;
      const float v = row < n_live ? acc[p][q] : 0.f;
      out[(int64_t)row * cout + col] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch(const void* feats, const void* weight, const void* rule, void* out,
           int v_out, int n_live, int cin, int cout, int n_offsets,
           void* stream) {
  dim3 grid((v_out + TM - 1) / TM, (cout + TN - 1) / TN);
  subm_conv_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)feats, (const T*)weight, (const int32_t*)rule, (T*)out,
      v_out, n_live, cin, cout, n_offsets);
  return (int)cudaGetLastError();
}

}  // namespace

// feats (v_in, cin), weight (n_offsets, cin, cout) in one type, rule
// (n_offsets, v_out) int32, out (v_out, cout)
extern "C" int tl_subm_conv_f32(const void* feats, const void* weight,
                                const void* rule, void* out, int v_in,
                                int v_out, int n_live, int cin, int cout,
                                int n_offsets, void* stream) {
  (void)v_in;
  return launch<float>(feats, weight, rule, out, v_out, n_live, cin, cout,
                       n_offsets, stream);
}

extern "C" int tl_subm_conv_bf16(const void* feats, const void* weight,
                                 const void* rule, void* out, int v_in,
                                 int v_out, int n_live, int cin, int cout,
                                 int n_offsets, void* stream) {
  (void)v_in;
  return launch<__nv_bfloat16>(feats, weight, rule, out, v_out, n_live, cin,
                               cout, n_offsets, stream);
}

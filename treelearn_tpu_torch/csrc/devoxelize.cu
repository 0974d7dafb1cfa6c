// devoxelize: the voxel -> point gather and its backward, a per-voxel sum.
//
// Replaces no Pallas kernel: the JAX package gathers with
// ``voxel_feats[v2p]`` (treelearn_tpu/ops/voxelize.py:devoxelize) and XLA
// transposes that gather into a scatter-add.  The port did the same through
// PyTorch's indexing, whose backward sorts the indices and gives each run of
// equal indices to one warp.  A training batch is padded to a power of two
// (data/dataset.py:collate_padded), and every padded point maps to the
// sentinel slot V, which that gather clamped onto voxel V-1: one warp then
// walked a run of ~470,000 rows, hundreds of milliseconds a step.
//
// Forward: out[p] = feats[v2p[p]] where v2p[p] < V, zeros otherwise.  Rows
// move as 16-byte lanes (8 bf16 or 4 float32 channels), neighbouring
// threads on neighbouring lanes of one row, so a row is one coalesced
// segment; the kernel never looks at the values, so it is the same for
// either dtype.
//
// Backward: dfeats[v] = sum of grad[p_order[j]] over j in
// [v_start[v], v_start[v+1]): the voxel -> point CSR that voxelize_points
// builds from its stable sort, each voxel's points in ascending point
// index, padded points outside every range.  A thread owns one 16-byte lane
// of one voxel, sums it in float32 in that order and rounds once to the
// gradient's dtype; no atomics and no sort, so every launch gives the same
// bits, and they are the bits of the plain version (a float32 index_add_
// over the live points in ascending order, ops/voxelize.py).  A row of C
// channels takes C/8 lanes in bf16 and C/4 in float32 (4 at 32 bf16
// channels, 8 at 64), so a warp holds 32/lanes voxels.  Padded points are
// never read, and no voxel walks more rows than it has points.
//
// Bound: memory.  The forward reads v2p (8 B a point) and the voxel rows and
// writes every point's row; the backward reads v_start and p_order (4 B a
// voxel and a live point), each live point's gradient row once, and writes
// each voxel's row once: ~0.13 GB at PTv3's 64-channel training batch,
// ~40 us at 3.35 TB/s.
//
// Rows are 1, 2, 4, 8, 16 or 32 lanes (16 to 512 bytes); the wrapper refuses
// other widths and any dtype but bfloat16 and float32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int LANES>
__global__ void __launch_bounds__(THREADS)
devoxelize_fwd_kernel(const uint4* __restrict__ feats,
                      const int64_t* __restrict__ v2p,
                      uint4* __restrict__ out, int64_t total, int v) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int64_t p = i / LANES;
  const int lane = (int)(i % LANES);
  const int64_t s = __ldg(v2p + p);
  uint4 row = make_uint4(0u, 0u, 0u, 0u);
  if (s >= 0 && s < v) row = __ldg(feats + s * LANES + lane);
  out[i] = row;
}

// the two bf16 channels of a 32-bit word, widened exactly (little endian:
// the lower address is the low half)
__device__ __forceinline__ void add_word(float* acc, uint32_t w,
                                         __nv_bfloat16) {
  acc[0] += __uint_as_float(w << 16);
  acc[1] += __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void add_word(float* acc, uint32_t w, float) {
  acc[0] += __uint_as_float(w);
}

__device__ __forceinline__ uint32_t round_word(const float* acc,
                                               __nv_bfloat16) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(acc[0]));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(acc[1]));
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t round_word(const float* acc, float) {
  return __float_as_uint(acc[0]);
}

template <typename T, int LANES>
__global__ void __launch_bounds__(THREADS)
devoxelize_bwd_kernel(const uint4* __restrict__ grad,
                      const int32_t* __restrict__ p_order,
                      const int32_t* __restrict__ v_start,
                      uint4* __restrict__ dfeats, int v) {
  constexpr int PER_WORD = 4 / sizeof(T);      // channels in a 32-bit word
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t vox = t / LANES;
  if (vox >= v) return;
  const int lane = (int)(t % LANES);
  const int j0 = __ldg(v_start + vox);
  const int j1 = __ldg(v_start + vox + 1);
  float acc[4 * PER_WORD];
#pragma unroll
  for (int k = 0; k < 4 * PER_WORD; ++k) acc[k] = 0.0f;
  for (int j = j0; j < j1; ++j) {
    const int64_t p = __ldg(p_order + j);
    const uint4 g = __ldg(grad + p * LANES + lane);
    add_word(acc + 0 * PER_WORD, g.x, T());
    add_word(acc + 1 * PER_WORD, g.y, T());
    add_word(acc + 2 * PER_WORD, g.z, T());
    add_word(acc + 3 * PER_WORD, g.w, T());
  }
  dfeats[vox * LANES + lane] = make_uint4(
      round_word(acc + 0 * PER_WORD, T()),
      round_word(acc + 1 * PER_WORD, T()),
      round_word(acc + 2 * PER_WORD, T()),
      round_word(acc + 3 * PER_WORD, T()));
}

unsigned blocks_for(int64_t threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

template <int LANES>
int launch_fwd(const void* feats, const void* v2p, void* out, int n, int v,
               cudaStream_t stream) {
  const int64_t total = (int64_t)n * LANES;
  devoxelize_fwd_kernel<LANES><<<blocks_for(total), THREADS, 0, stream>>>(
      (const uint4*)feats, (const int64_t*)v2p, (uint4*)out, total, v);
  return (int)cudaGetLastError();
}

template <typename T, int LANES>
int launch_bwd(const void* grad, const void* p_order, const void* v_start,
               void* dfeats, int v, cudaStream_t stream) {
  devoxelize_bwd_kernel<T, LANES>
      <<<blocks_for((int64_t)v * LANES), THREADS, 0, stream>>>(
          (const uint4*)grad, (const int32_t*)p_order,
          (const int32_t*)v_start, (uint4*)dfeats, v);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* grad, const void* p_order, const void* v_start,
                 void* dfeats, int v, int lanes, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch_bwd<T, 1>(grad, p_order, v_start, dfeats, v, s);
    case 2: return launch_bwd<T, 2>(grad, p_order, v_start, dfeats, v, s);
    case 4: return launch_bwd<T, 4>(grad, p_order, v_start, dfeats, v, s);
    case 8: return launch_bwd<T, 8>(grad, p_order, v_start, dfeats, v, s);
    case 16: return launch_bwd<T, 16>(grad, p_order, v_start, dfeats, v, s);
    case 32: return launch_bwd<T, 32>(grad, p_order, v_start, dfeats, v, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// feats (V, lanes x 16 B), v2p (n,) int64 -> out (n, lanes x 16 B)
extern "C" int tl_devoxelize_fwd(const void* feats, const void* v2p,
                                 void* out, int n, int v, int lanes,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 1: return launch_fwd<1>(feats, v2p, out, n, v, s);
    case 2: return launch_fwd<2>(feats, v2p, out, n, v, s);
    case 4: return launch_fwd<4>(feats, v2p, out, n, v, s);
    case 8: return launch_fwd<8>(feats, v2p, out, n, v, s);
    case 16: return launch_fwd<16>(feats, v2p, out, n, v, s);
    case 32: return launch_fwd<32>(feats, v2p, out, n, v, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// grad (n, lanes x 16 B) of bf16 (bf16 = 1) or float32, p_order (n_live,)
// int32, v_start (V + 1,) int32 -> dfeats (V, lanes x 16 B)
extern "C" int tl_devoxelize_bwd(const void* grad, const void* p_order,
                                 const void* v_start, void* dfeats, int v,
                                 int lanes, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch_bwd<__nv_bfloat16>(grad, p_order, v_start, dfeats, v,
                                            lanes, s)
              : dispatch_bwd<float>(grad, p_order, v_start, dfeats, v, lanes,
                                    s);
}

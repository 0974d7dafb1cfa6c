// Weight gradient of the submanifold sparse convolution in float32 on the
// tensor cores, 3xTF32.
//
// Replaces the Pallas kernel _dw_kernel / rule_conv_dw_banded
// (treelearn_tpu/ops/pallas_conv.py:415,438) for float32 inputs whose
// channel counts are multiples of 8 (the 4 -> 32 input conv's x zero-padded
// to 8 channels by the wrapper, other widths that are no multiple of 8
// likewise), at any offset count.
//
//   dW[k] = sum_i x[rule[k, i]]^T g[i]      (rule -1: no input)
//   x (V, Cin), g (V, Cout) float32, float32 sums, dW (K, Cin, Cout)
//
// Bound on the card: the products (2 Cin Cout per rule entry), taken as
// three TF32 products each (hi(a) hi(b) + hi(a) lo(b) + lo(a) hi(b), see
// subm_conv_tf32.cu): float32 accuracy at 495 / 3 TFLOP/s.  At 8..224
// channels they take microseconds; a launch pays for bringing the gathered
// rows x[rule[k, i]] and the rows g[i] into shared memory and for the split
// and transpose of g below.  The design:
//
// * dW[k] = X_k^T G with the voxel rows as the reduction dimension.  M is
//   64 rows of the flattened (offset, input channel) axis of dW, K * Cin
//   long: 8 groups of 8 channels, each of its own offset, so one block
//   covers 8 offsets at Cin = 8 and a 64-channel slice of one at Cin >= 64
//   (K * Cin / 64 blocks along M, the last one ragged and masked).  N is
//   the whole Cout up to 128 (224 -> 2 x 112).
// * TF32 operands in shared memory must be K-major (the transpose flags
//   exist for 16-bit types only), and here K is the voxel rows: both
//   operands arrive row-major, one voxel a row.  A = X_k^T goes from
//   registers: each consumer thread reads its four values of a k8 step
//   from the row-major slab (a strided read that the layout keeps free of
//   bank conflicts), splits them into hi and lo and issues the products.
//   B = G must lie in shared memory, K-major, so the consumers transpose
//   each slot's g rows into hi and lo images (tiles of BN output channels
//   x 8 rows in the 32-byte swizzle, 16-byte stores) before the products.
//   Why X on M and G on N, not the other way round: M is 64 rows a
//   warpgroup, and the flattened (offset, channel) axis fills it at any
//   Cin (8 groups of 8); N takes Cout = 8..224 in steps of 8, which M
//   could not without padding.
// * Warp specialisation as in subm_conv_dw_wgmma.cu: 4 producer warps fill
//   a ring of `stages` slots of R = 32 rows with 16-byte cp.async (x rows
//   of the 8 groups' offsets, zero-fill for rule -1 and past the chunk's
//   end; g rows), each arriving on the slot's full mbarrier by itself.
//   The consumer warpgroup splits, transposes, hands the slot back once the
//   split is done, and multiplies from the staged images and registers;
//   it waits for a slot's products before the next split (one staging
//   buffer, and no A register rewritten under a running wgmma), which a
//   second block on the SM covers.
// * Output-stationary over a row chunk: float32 sums in registers, each
//   slot's products started afresh and added into them with
//   round-to-nearest FADDs (the tensor cores' own accumulation truncates:
//   over a chunk of 20,000 rows it was 1.2e-4 of max |dW| off on the H100;
//   see subm_conv_tf32.cu), written to partial[chunk]; the chunks are
//   added in order by the second pass (dw_reduce.cuh).  No atomics: two
//   launches give the same bits.  One chunk writes dW itself.

#include <cuda_runtime.h>
#include <stdint.h>
#include "dw_reduce.cuh"
#include "wgmma.cuh"

namespace {

constexpr int R = 32;            // rows of a slot: 4 k8 steps
constexpr int MT = 64;           // flattened (offset, channel) rows a block
constexpr int PRODUCERS = 128;
constexpr int NT = 128 + PRODUCERS;
constexpr int MAX_STAGES = 8;
constexpr int A_BYTES = R * MT * 4;   // x slab of a slot, 256 bytes a row

// BN: output channels per block.  Grid: (M blocks, Cout / BN, row chunks).
// Dynamic shared memory, from a 1024-byte aligned base:
//   staging   hi images (R / 8 x BN x 32 bytes), then lo images: B of a slot
//   ring      stages x (x slab R x 64 float32, g rows R x BN float32)
//   full[8], empty[8] mbarriers
template <int BN>
__global__ void __launch_bounds__(NT, 1)
dw_tf32_kernel(const float* __restrict__ x, const float* __restrict__ g,
               const int32_t* __restrict__ rule, float* __restrict__ partial,
               int v, int cin, int cout, int n_offsets, int rows_per_chunk,
               int stages) {
  constexpr int IMG = BN * 32;              // one k8 tile of B
  constexpr int STAGING = 2 * (R / 8) * IMG;
  constexpr int G_BYTES = R * BN * 4;
  constexpr int STAGE_BYTES = A_BYTES + G_BYTES;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* staging = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t staging_addr = smem_u32(staging);
  uint8_t* ring = staging + STAGING;
  const uint32_t ring_addr = smem_u32(ring);
  uint8_t* after_ring = ring + (size_t)stages * STAGE_BYTES;
  const uint32_t full_bar = smem_u32(after_ring);       // + 8 * slot
  const uint32_t empty_bar = full_bar + 8 * MAX_STAGES;

  const int tid = threadIdx.x;
  const int flat_total = n_offsets * cin;
  const int m0 = blockIdx.x * MT;
  const int n0 = blockIdx.y * BN;
  const int chunk = blockIdx.z;
  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(v, row_begin + rows_per_chunk);
  const int n_stages =
      row_end > row_begin ? (row_end - row_begin + R - 1) / R : 0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_bar + 8 * s, PRODUCERS);
      mbar_init(empty_bar + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer warps: fill the ring, never touch the output
    const int p = tid - 128;
    // x: thread p copies 16-byte half h of group j of rows p / 16 + 8 i
    const int j = (p >> 1) & 7;
    const int h = p & 1;
    const int f = m0 + 8 * j;
    const bool group_on = f < flat_total;
    const int kj = group_on ? f / cin : 0;
    const int cj = group_on ? f - kj * cin : 0;
    const int32_t* rule_j = rule + (int64_t)kj * v;
    const float* x_col = x + cj + 4 * h;
    const int q = 2 * j + h;   // chunk of the 256-byte row
    int slot = 0;
    uint32_t phase = 0;
    bool refill = false;
    for (int s = 0; s < n_stages; ++s) {
      const int first = row_begin + s * R;
      if (refill) mbar_wait(empty_bar + 8 * slot, phase ^ 1u);
      const uint32_t base = ring_addr + slot * STAGE_BYTES;
#pragma unroll
      for (int i = 0; i < R / 8; ++i) {
        const int r = (p >> 4) + 8 * i;
        const int row = first + r;
        const int src = group_on && row < row_end ? rule_j[row] : -1;
        cp_async16(base + r * 256 + ((q ^ ((r & 3) << 1)) << 4),
                   x_col + (int64_t)(src < 0 ? 0 : src) * cin,
                   src < 0 ? 0u : 16u);
      }
      const uint32_t g_base = base + A_BYTES;
      for (int e = p; e < R * (BN / 4); e += PRODUCERS) {
        const int r = e / (BN / 4);
        const int c = e - r * (BN / 4);
        const int row = first + r;
        const bool on = row < row_end;
        cp_async16(g_base + r * (BN * 4) + c * 16,
                   g + (int64_t)(on ? row : 0) * cout + n0 + 4 * c,
                   on ? 16u : 0u);
      }
      cp_async_arrive(full_bar + 8 * slot);
      if (++slot == stages) {
        slot = 0;
        phase ^= 1u;
        refill = true;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumer warpgroup
  const int lane = tid & 31;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int m_lo = 16 * (tid >> 5) + g8;   // this thread's rows of dW's tile
  float acc[BN / 2], total[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = total[i] = 0.f;

  int slot = 0;
  uint32_t phase = 0;
  for (int s = 0; s < n_stages; ++s) {
    mbar_wait(full_bar + 8 * slot, phase);
    const uint8_t* slab = ring + slot * STAGE_BYTES;
    const float* g_rows = (const float*)(slab + A_BYTES);
    // g rows -> K-major hi and lo images: job (k8 step, half, n) reads 4
    // rows of channel n and writes one 16-byte chunk of each image
    for (int job = tid; job < (R / 4) * BN; job += 128) {
      const int n = job % BN;
      const int hk = job / BN;       // k8 step * 2 + half
      const float* src = g_rows + (4 * hk) * BN + n;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(src[e * BN], hi[e], lo[e]);
      const int off = (hk >> 1) * IMG + n * 32 +
                      (((hk & 1) ^ ((n >> 2) & 1)) << 4);
      *(uint4*)(staging + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *(uint4*)(staging + (R / 8) * IMG + off) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    // A fragments of X_k^T: element (m, row) of the slab
    uint32_t ah[R / 8][4], al[R / 8][4];
    const float* xs = (const float*)slab;
#pragma unroll
    for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m_lo + 8 * (i & 1);
        const int row = 8 * kk + t4 + 4 * (i >> 1);
        const float val =
            xs[row * MT + (((m >> 2) ^ ((row & 3) << 1)) << 2) + (m & 3)];
        tf32_split(val, ah[kk][i], al[kk][i]);
      }
    fence_proxy_async();   // the images were written through the generic proxy
    consumer_sync<128>();
    // every read of the slot is over (the values are in registers and images)
    if (tid == 0) mbar_arrive(empty_bar + 8 * slot);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 8; ++kk)
      mma_tf32x3<BN>(acc, ah[kk], al[kk],
                     tf32_desc(staging_addr + kk * IMG),
                     tf32_desc(staging_addr + (R / 8 + kk) * IMG), kk == 0);
    wgmma_commit();
    wgmma_wait<0>();   // the images may be rewritten, the registers reused
    tf32_flush<BN>(total, acc);
#pragma unroll
    for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        reg_fence(ah[kk][i]);
        reg_fence(al[kk][i]);
      }
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int f = m0 + m_lo + 8 * half;
    if (f >= flat_total) continue;
    float* out = partial + ((int64_t)chunk * flat_total + f) * cout + n0 +
                 2 * t4;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj)
      *(float2*)(out + 8 * jj) =
          make_float2(total[4 * jj + 2 * half],
                      total[4 * jj + 2 * half + 1]);
  }
}

template <int BN>
int launch(const void* x, const void* g, const void* rule, void* partial,
           void* dw, int v, int cin, int cout, int n_offsets, int n_chunks,
           int rows_per_chunk, int stages, int smem_bytes,
           cudaStream_t stream) {
  auto kernel = dw_tf32_kernel<BN>;
  // above 48 KB a kernel must be granted its dynamic shared memory; the
  // grant is per device, so it is renewed at every launch
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n_offsets * cin + MT - 1) / MT, cout / BN, n_chunks);
  // one chunk: its partial is dW
  void* first = n_chunks == 1 ? dw : partial;
  kernel<<<grid, NT, smem_bytes, stream>>>(
      (const float*)x, (const float*)g, (const int32_t*)rule, (float*)first,
      v, cin, cout, n_offsets, rows_per_chunk, stages);
  int err = (int)cudaGetLastError();
  if (err != 0 || n_chunks == 1) return err;
  return launch_dw_reduce(partial, dw, n_chunks,
                          (int64_t)n_offsets * cin * cout, stream);
}

}  // namespace

// x (v, cin), g (v, cout) float32, rule (n_offsets, v) int32, partial
// (n_chunks, n_offsets, cin, cout) float32 scratch (unused with one chunk),
// dw (n_offsets, cin, cout) float32.  bn, stages, n_chunks, rows_per_chunk,
// smem_bytes: the plan of ops/subm_conv.py:dw_plan; rows_per_chunk is a
// multiple of 32 and n_chunks * rows_per_chunk >= v.
extern "C" int tl_subm_conv_dw_tf32(const void* x, const void* g,
                                    const void* rule, void* partial, void* dw,
                                    int v, int cin, int cout, int n_offsets,
                                    int bn, int stages, int n_chunks,
                                    int rows_per_chunk, int smem_bytes,
                                    void* stream) {
  if (cin <= 0 || cin % 8 != 0 || bn <= 0 || cout % bn != 0 ||
      stages < 2 || stages > MAX_STAGES || n_offsets < 1 || n_chunks < 1 ||
      rows_per_chunk % R != 0 || (int64_t)n_chunks * rows_per_chunk < v)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define TL_CASE(BN)                                                         \
  if (bn == BN)                                                             \
    return launch<BN>(x, g, rule, partial, dw, v, cin, cout, n_offsets,     \
                      n_chunks, rows_per_chunk, stages, smem_bytes, s);
  // the widths ops/subm_conv.py:TF32_BN lists
  TL_CASE(8)
  TL_CASE(16)
  TL_CASE(24)
  TL_CASE(32)
  TL_CASE(40)
  TL_CASE(48)
  TL_CASE(56)
  TL_CASE(64)
  TL_CASE(80)
  TL_CASE(96)
  TL_CASE(112)
  TL_CASE(128)
#undef TL_CASE
  return (int)cudaErrorInvalidValue;
}

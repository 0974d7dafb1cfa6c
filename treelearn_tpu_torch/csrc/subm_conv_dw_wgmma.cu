// Weight gradient of the submanifold sparse convolution on the tensor cores.
//
// Replaces the Pallas kernel _dw_kernel / rule_conv_dw_banded
// (treelearn_tpu/ops/pallas_conv.py:415,438) for every bf16 weight gradient
// of the port: any offset count (27 at kernel_size 3, 125 at 5; a launch
// argument) and any Cin and Cout in multiples of 8 (ops/subm_conv.py
// zero-pads other widths first).
//
//   dW[k] = sum_i x[rule[k, i]]^T g[i]      (rule -1: no input)
//   x (V, Cin), g (V, Cout) bf16, float32 sums, dW (K, Cin, Cout) float32
//
// Bound on the card: operations by the count (2 Cin Cout per rule entry),
// but at 32..448 channels the tensor cores finish them in microseconds; what
// a launch pays for is bringing the gathered rows x[rule[k, i]] and the rows
// g[i] into shared memory (16-byte copies through L2, g once for every
// offset and input slice) and, at the deepest levels, the launch itself.
// The design follows from that:
//
// * dW[k] = X_k^T G with the voxel rows as the reduction dimension.  Rows
//   land in shared memory as they lie in device memory, one voxel a row, in
//   slabs of 32 channels (64 bytes a row, 64-byte swizzle: the 16-byte chunk
//   c of row r lies at r * 64 + ((c ^ ((r >> 1) & 3)) << 4), slabs 1024-byte
//   aligned).  The reduction dimension is then the strided one for both
//   operands, so both are MN-major (wgmma's transpose flags, 16-bit types
//   only): a slab is a column of swizzle atoms of 8 rows x 32 channels, the
//   leading offset of a descriptor is the distance between slabs (the next
//   32 channels), its stride offset the 512 bytes between 8-row groups, and
//   a K step of 16 rows advances the start address by 1024 bytes.
// * M is 64 rows of dW's flattened (offset, input channel) axis, K * Cin
//   long: block b takes rows 64 b .. 64 b + 63, two slabs of 32.  Each
//   16-byte chunk of a slab row is 8 of those rows, i.e. 8 channels of one
//   offset (Cin is a multiple of 8), so a chunk has its own offset and
//   gathers from its own rule row: at Cin = 32 a block sums two offsets at
//   once, at Cin = 16 four, at Cin = 48 the slabs straddle offsets; rows
//   past K * Cin are zero (zero-fill copies) and not written.  N is the
//   whole Cout up to 256 (384 -> 2 x 192) in slabs of 32 channels; where
//   Cout is no multiple of 32 the last slab's chunks past Cout are zero
//   and not written (the products are free; the bytes are not read).
// * Warp specialisation as in subm_conv_wgmma.cu: producer threads fill a
//   ring of `stages` slots with cp.async that arrive on the slot's full
//   mbarrier by themselves, the consumer warpgroup multiplies and hands the
//   slot back on its empty mbarrier.  A slot holds R = PRODUCERS / 4 rows
//   (R / 16 K steps); producer thread p copies chunk p % 4 of row p / 4 of
//   every slab, so it needs two rule entries a slot (its chunk's offset in
//   each A slab), which it loads one slot ahead.  A row that no chunk's
//   offset has (the four threads of a row vote) is not read from g either
//   (zero-fill form), and a K step none of whose 16 rows has an offset is
//   not multiplied: each producer warp flags its 8 rows, two flags a step.
// * Output-stationary: float32 accumulators in registers over a row chunk,
//   written to partial[chunk]; the chunks are added in order by the second
//   pass (dw_reduce.cuh).  No atomics, two launches give the same bits.  One
//   chunk writes dW itself and skips the second pass.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include "dw_reduce.cuh"
#include "wgmma.cuh"

namespace {

constexpr int SLAB_CH = 32;            // channels (M or N rows) of a slab
constexpr int ROW_BYTES = SLAB_CH * 2;
constexpr int MAX_STAGES = 8;
constexpr int MAX_P_WARPS = 8;

// Descriptor of an MN-major operand in the 64-byte swizzle whose first K
// row lies at `addr`: slabs `slab_bytes` apart (leading offset), 8-row
// groups 512 bytes apart (stride offset).
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr,
                                            uint32_t slab_bytes) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)(slab_bytes >> 4) << 16;
  d |= (uint64_t)(8 * ROW_BYTES >> 4) << 32;
  d |= (uint64_t)2 << 62;
  return d;
}

// BN: output channels per block; PRODUCERS (128 or 256) threads produce,
// 128 consume.  Grid: (64-row tiles of K * Cin, Cout splits, row chunks).
// Dynamic shared memory, from a 1024-byte aligned base:
//   ring      stages x (2 + BN / 32) slabs of R rows x 64 bytes
//   full[8], empty[8] mbarriers
//   flags     [8 slots][8 producer warps]: some row of the warp's 8 is live
template <int BN, int PRODUCERS>
__global__ void __launch_bounds__(128 + PRODUCERS, 1)
dw_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ g,
                const int32_t* __restrict__ rule, float* __restrict__ partial,
                int v, int cin, int cout, int n_offsets, int rows_per_chunk,
                int stages) {
  constexpr int R = PRODUCERS / 4;          // rows of a slot
  constexpr int SLAB_BYTES = R * ROW_BYTES;
  constexpr int B_SLABS = BN / SLAB_CH;
  constexpr int STAGE_BYTES = (2 + B_SLABS) * SLAB_BYTES;
  constexpr int P_WARPS = PRODUCERS / 32;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t ring_addr = smem_u32(ring);
  uint8_t* after_ring = ring + (size_t)stages * STAGE_BYTES;
  const uint32_t full_bar = smem_u32(after_ring);       // + 8 * slot
  const uint32_t empty_bar = full_bar + 8 * MAX_STAGES;
  volatile int* flags = (volatile int*)(after_ring + 16 * MAX_STAGES);

  const int tid = threadIdx.x;
  const int m_total = n_offsets * cin;   // rows of the flattened M axis
  const int m0 = 64 * blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int chunk = blockIdx.z;
  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(v, row_begin + rows_per_chunk);
  const int n_stages = row_end > row_begin ? (row_end - row_begin + R - 1) / R
                                           : 0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // a slot is full when every producer thread's copies have landed and
      // every producer warp has written its flag
      mbar_init(full_bar + 8 * s, PRODUCERS + P_WARPS);
      mbar_init(empty_bar + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer warps: fill the ring, never touch the output
    const int p = tid - 128;
    const int r = p >> 2;
    const int c = p & 3;
    const uint32_t swz = r * ROW_BYTES + ((c ^ ((r >> 1) & 3)) << 4);
    // this thread's chunk of each A slab: M rows m0 + 8 c (slab 0) and
    // m0 + 32 + 8 c (slab 1), each 8 channels of one offset
    const int m_a = m0 + 8 * c, m_b = m_a + SLAB_CH;
    const bool has0 = m_a < m_total, has1 = m_b < m_total;
    const int k0 = has0 ? m_a / cin : 0, k1 = has1 ? m_b / cin : 0;
    const int32_t* rule0 = rule + (int64_t)k0 * v;
    const int32_t* rule1 = rule + (int64_t)k1 * v;
    const __nv_bfloat16* x0 = x + (has0 ? m_a - k0 * cin : 0);
    const __nv_bfloat16* x1 = x + (has1 ? m_b - k1 * cin : 0);
    // g's chunk c of every B slab: columns n0 + 32 j + 8 c, zero past cout
    const __nv_bfloat16* gcol = g + n0 + c * 8;
    int row = row_begin + r;
    int i0 = -1, i1 = -1;
    if (row < row_end) {
      if (has0) i0 = rule0[row];
      if (has1) i1 = rule1[row];
    }
    int slot = 0;
    uint32_t phase = 0;
    bool refill = false;   // the ring has gone round: wait for the consumer
    for (int s = 0; s < n_stages; ++s) {
      const int next_row = row + R;
      int j0 = -1, j1 = -1;   // the next slot's rule entries, loaded early
      if (s + 1 < n_stages && next_row < row_end) {
        if (has0) j0 = rule0[next_row];
        if (has1) j1 = rule1[next_row];
      }
      if (refill) mbar_wait(empty_bar + 8 * slot, phase ^ 1u);
      const uint32_t base = ring_addr + slot * STAGE_BYTES + swz;
      const uint32_t bar = full_bar + 8 * slot;
      cp_async16(base, x0 + (int64_t)(i0 < 0 ? 0 : i0) * cin,
                 i0 < 0 ? 0u : 16u);
      cp_async16(base + SLAB_BYTES, x1 + (int64_t)(i1 < 0 ? 0 : i1) * cin,
                 i1 < 0 ? 0u : 16u);
      // the four threads of a row vote: g's row is needed where any chunk
      // of the row has an input
      const unsigned any = __ballot_sync(0xffffffffu, i0 >= 0 || i1 >= 0);
      const bool live = (any >> (p & 28)) & 0xFu;
      const __nv_bfloat16* grow = gcol + (int64_t)(live ? row : 0) * cout;
#pragma unroll
      for (int j = 0; j < B_SLABS; ++j) {
        const bool in = live && n0 + j * SLAB_CH + c * 8 < cout;
        cp_async16(base + (2 + j) * SLAB_BYTES,
                   in ? grow + j * SLAB_CH : g, in ? 16u : 0u);
      }
      cp_async_arrive(bar);
      if ((p & 31) == 0) {
        flags[slot * MAX_P_WARPS + (p >> 5)] = any != 0u;
        mbar_arrive(bar);
      }
      row = next_row;
      i0 = j0;
      i1 = j1;
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
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  int slot = 0, prev_slot = 0;
  uint32_t phase = 0;
  for (int s = 0; s < n_stages; ++s) {
    mbar_wait(full_bar + 8 * slot, phase);
    fence_proxy_async();   // the rows came through the generic proxy
    const uint32_t a_addr = ring_addr + slot * STAGE_BYTES;
    const uint64_t da = mn_desc(a_addr, SLAB_BYTES);
    const uint64_t db = mn_desc(a_addr + 2 * SLAB_BYTES, SLAB_BYTES);
    wgmma_fence();
#pragma unroll
    for (int step = 0; step < R / 16; ++step) {
      // 16 rows = the 8 rows each of two producer warps
      const int* f = (const int*)flags + slot * MAX_P_WARPS + 2 * step;
      if (f[0] | f[1])
        Wgmma<BN, 1>::mma(acc, da + step * (16 * ROW_BYTES >> 4),
                          db + step * (16 * ROW_BYTES >> 4));
    }
    wgmma_commit();
    wgmma_wait<1>();       // slot s - 1 has retired: it may be refilled
    if (s > 0 && tid == 0) mbar_arrive(empty_bar + 8 * prev_slot);
    prev_slot = slot;
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
  wgmma_wait<0>();

  // row t of the tile is row m0 + t of the flattened (offset, channel)
  // axis, i.e. of partial[chunk] seen as (K * Cin, Cout); this thread holds
  // rows trow and trow + 8
  const int trow = 16 * (tid / 32) + (tid % 32) / 4;
  const int col = n0 + 2 * (tid % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + trow + 8 * half;
    if (m >= m_total) continue;
    float* out = partial + ((int64_t)chunk * m_total + m) * cout + col;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      if (col + 8 * j < cout)
        *(float2*)(out + 8 * j) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

template <int BN, int PRODUCERS>
int launch(const void* x, const void* g, const void* rule, void* partial,
           void* dw, int v, int cin, int cout, int n_offsets, int n_chunks,
           int rows_per_chunk, int stages, int smem_bytes,
           cudaStream_t stream) {
  auto kernel = dw_wgmma_kernel<BN, PRODUCERS>;
  // above 48 KB a kernel must be granted its dynamic shared memory; the
  // grant is per device, so it is renewed at every launch
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int64_t m_total = (int64_t)n_offsets * cin;
  dim3 grid((unsigned)((m_total + 63) / 64), (cout + BN - 1) / BN, n_chunks);
  // one chunk: its partial is dW
  void* first = n_chunks == 1 ? dw : partial;
  kernel<<<grid, 128 + PRODUCERS, smem_bytes, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (const int32_t*)rule,
      (float*)first, v, cin, cout, n_offsets, rows_per_chunk, stages);
  int err = (int)cudaGetLastError();
  if (err != 0 || n_chunks == 1) return err;
  return launch_dw_reduce(partial, dw, n_chunks, m_total * cout, stream);
}

}  // namespace

// x (v, cin), g (v, cout) bf16, rule (n_offsets, v) int32, partial
// (n_chunks, n_offsets, cin, cout) float32 scratch (unused with one chunk),
// dw (n_offsets, cin, cout) float32.  bn, producers, stages, n_chunks,
// rows_per_chunk, smem_bytes: the plan of ops/subm_conv.py:dw_plan; bn is a
// multiple of 32 (the last split may reach past cout), rows_per_chunk a
// multiple of producers / 4 and n_chunks * rows_per_chunk >= v.
extern "C" int tl_subm_conv_dw_wgmma(const void* x, const void* g,
                                     const void* rule, void* partial,
                                     void* dw, int v, int cin, int cout,
                                     int n_offsets, int bn, int producers,
                                     int stages, int n_chunks,
                                     int rows_per_chunk, int smem_bytes,
                                     void* stream) {
  if (cin <= 0 || cin % 8 != 0 || cout <= 0 || cout % 8 != 0 ||
      n_offsets < 1 || bn <= 0 || bn % SLAB_CH != 0 ||
      stages < 2 || stages > MAX_STAGES ||
      (producers != 128 && producers != 256) || n_chunks < 1 ||
      rows_per_chunk % (producers / 4) != 0 ||
      (int64_t)n_chunks * rows_per_chunk < v)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define TL_CASE(BN, PRODUCERS)                                              \
  if (bn == BN && producers == PRODUCERS)                                   \
    return launch<BN, PRODUCERS>(x, g, rule, partial, dw, v, cin, cout,     \
                                 n_offsets, n_chunks, rows_per_chunk,       \
                                 stages, smem_bytes, s);
#define TL_BOTH(BN) TL_CASE(BN, 128) TL_CASE(BN, 256)
  TL_BOTH(32)
  TL_BOTH(64)
  TL_BOTH(96)
  TL_BOTH(128)
  TL_BOTH(160)
  TL_BOTH(192)
  TL_BOTH(224)
  TL_BOTH(256)
#undef TL_BOTH
#undef TL_CASE
  return (int)cudaErrorInvalidValue;
}

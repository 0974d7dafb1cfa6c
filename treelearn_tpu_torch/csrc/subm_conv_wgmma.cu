// Submanifold sparse convolution as a bf16 gather-GEMM on the tensor cores.
//
// Replaces the Pallas kernel _subm_kernel + _gather_bands
// (treelearn_tpu/ops/pallas_conv.py:304,181) for bf16 features whose
// channel counts are multiples of 32; csrc/subm_conv.cu keeps float32 and
// odd widths.
//
//   out[i] = sum_k feats[rule[k, i]] @ W[k]      (rule -1: no input)
//   bf16 in, float32 sums, bf16 out, rows i >= n_live are zeros
//
// Bound on the card: the arithmetic is tiny against the tensor-core rate
// (32..224 channels), so what a launch costs is the gather of 64..448-byte
// feature rows through L2 and, at the deepest levels, the latency of one
// block's walk over its K steps.  The design follows from that:
//
// * A block owns BM = 64 output voxels (one consumer warpgroup; two and 128
//   for 32-channel convs over very many voxels) and BN output channels, the
//   whole Cout where it fits 256, so every gathered row is read once per
//   block.  Small levels split Cout into 32-channel blocks to fill the card
//   (ops/subm_conv.py:conv_plan decides).  It is output-stationary: float32
//   accumulators stay in registers, nothing is added atomically, and two
//   launches give the same bits.
// * K loop = (offsets that some row of the tile uses) x (Cin in slices of
//   BK = 32).  Rows that lack a present offset are zero rows of A.
// * A (gathered rows) comes in by 16-byte cp.async, zero-fill form for
//   rule -1; B (the weight tile) is a packed image that ops/subm_conv.py
//   prepared in exactly the shared-memory layout below, so it is copied
//   linearly.  Both are K-major with 64-byte rows in the 64-byte swizzle
//   that wgmma descriptors understand: the 16-byte chunk c of row r lies at
//   r * 64 + ((c ^ ((r >> 1) & 3)) << 4), tiles 1024-byte aligned.
// * Warp specialisation: 4 or 8 producer warps fill a ring of `stages` slots
//   and the consumer warpgroup(s) multiply from it, each slot with a full
//   and an empty mbarrier.  On the H100 starting the 16-byte gather
//   copies holds a warp far longer than a step's products take (a block
//   that did both in turn spent most of every step there), so it must run
//   beside the products, not before them.  Where the grid is at most one
//   wave of blocks, so that a block's K loop is the launch's length, it runs
//   on as many warps as a step has copy instructions (64 rows x 64 bytes =
//   8 warp-wide copies); larger grids do better with 4, more blocks fitting
//   an SM.  A producer thread starts its share and lets it arrive on the
//   slot's full barrier on completion (cp.async.mbarrier.arrive.noinc), so
//   it never waits for its own copies; the copy engine brings the weight
//   tile (cp.async.bulk, counted in bytes on the same barrier), started by
//   each warp in turn.  A consumer warpgroup waits for full, launches the
//   step's two wgmma, and releases the previous step's slot once
//   wgmma.wait_group says it has retired.
// * The row copies write through the generic proxy and wgmma reads through
//   the async proxy, hence fence.proxy.async between the consumer's wait
//   and its wgmma.
// * Epilogue: accumulators -> bf16 -> a padded tile in the (now idle) ring
//   -> 16-byte row stores.
//
// The inline-PTX wrappers (copies, mbarriers, fences, wgmma) are in
// wgmma.cuh, shared with the weight-gradient kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include "wgmma.cuh"

namespace {

constexpr int BK = 32;                 // input channels per K step
constexpr int ROW_BYTES = BK * 2;      // one K-major row of a tile
constexpr int N_OFFSETS = 27;
constexpr int MAX_STAGES = 8;

// Shared-memory matrix descriptor of a K-major tile with 64-byte rows in
// the 64-byte swizzle: 8-row groups 512 bytes apart; the leading offset is
// not used by swizzled K-major layouts.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(8 * ROW_BYTES >> 4) << 32;
  d |= (uint64_t)2 << 62;
  return d;
}


// BN: output channels per block; NWG: consumer warpgroups of 64 output rows
// each; PRODUCERS (128 or 256) more threads produce.  Dynamic shared memory,
// from a 1024-byte aligned base:
//   ring      stages x (A tile BM x 64 B, B tile BN x 64 B)
//   full[8], empty[8] mbarriers
//   rule_s    27 x BM int32, -1 for no input and for rows past n_live
//   k_list    the present offsets, then their count; present[27] flags
template <int BN, int NWG, int PRODUCERS>
__global__ void __launch_bounds__(NWG * 128 + PRODUCERS, 1)
subm_conv_wgmma_kernel(const __nv_bfloat16* __restrict__ feats,
                       const __nv_bfloat16* __restrict__ wpack,
                       const int32_t* __restrict__ rule,
                       __nv_bfloat16* __restrict__ out, int v_out, int n_live,
                       int cin, int cout, int stages) {
  constexpr int BM = 64 * NWG;
  constexpr int NT = 128 * NWG + PRODUCERS;
  constexpr int A_BYTES = BM * ROW_BYTES;
  constexpr int B_BYTES = BN * ROW_BYTES;
  constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  constexpr int OUT_STRIDE = BN + 8;   // bf16 values; +8 spreads the banks

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t ring_addr = smem_u32(ring);
  uint8_t* after_ring = ring + (size_t)stages * STAGE_BYTES;
  const uint32_t full_bar = smem_u32(after_ring);       // + 8 * slot
  const uint32_t empty_bar = full_bar + 8 * MAX_STAGES;
  int32_t* rule_s = (int32_t*)(after_ring + 16 * MAX_STAGES);
  int* k_list = (int*)(rule_s + N_OFFSETS * BM);   // [27] offsets, [27] count
  int* present = k_list + N_OFFSETS + 1;           // [27] flags

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int n_slices = cin / BK;

  if (tid < N_OFFSETS) present[tid] = 0;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // a slot is full when every producer thread's row copies and the
      // weight tile's bytes have landed (one more arrival announces those)
      mbar_init(full_bar + 8 * s, PRODUCERS + 1);
      mbar_init(empty_bar + 8 * s, NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();
  for (int e = tid; e < N_OFFSETS * BM; e += NT) {
    const int k = e / BM;
    const int row = row0 + (e - k * BM);
    int src = -1;
    if (row < v_out && row < n_live) src = rule[(int64_t)k * v_out + row];
    rule_s[e] = src;
    if (src >= 0) present[k] = 1;
  }
  __syncthreads();
  if (tid < 32) {   // compact the present offsets, in order
    const unsigned mask =
        __ballot_sync(0xffffffffu, tid < N_OFFSETS && present[tid]);
    if (mask >> tid & 1u) k_list[__popc(mask & ((1u << tid) - 1u))] = tid;
    if (tid == 0) k_list[N_OFFSETS] = __popc(mask);
  }
  __syncthreads();
  const int n_offsets = k_list[N_OFFSETS];

  if (tid >= NWG * 128) {
    // ---- producer warps: fill the ring, never touch the output
    const int p = tid - NWG * 128;
    int slot = 0, step = 0;
    uint32_t phase = 0;
    bool refill = false;   // the ring has gone round: wait for the consumers
    for (int ki = 0; ki < n_offsets; ++ki) {
      const int k = k_list[ki];
      const int32_t* idx = rule_s + k * BM;
      const __nv_bfloat16* image =
          wpack + ((int64_t)k * n_splits + split) * n_slices * (BN * BK);
      for (int slice = 0; slice < n_slices; ++slice) {
        if (refill) mbar_wait(empty_bar + 8 * slot, phase ^ 1u);
        const uint32_t a_addr = ring_addr + slot * STAGE_BYTES;
        const uint32_t bar = full_bar + 8 * slot;
        // the warps take turns at the weight tile: starting it costs about
        // as much as a warp's row copies
        if (p == 32 * (step++ % (PRODUCERS / 32))) {
          mbar_expect_tx(bar, B_BYTES);
          bulk_copy(a_addr + A_BYTES, image + slice * (BN * BK), B_BYTES, bar);
        }
        const __nv_bfloat16* col = feats + slice * BK;
#pragma unroll
        for (int q = p; q < BM * 4; q += PRODUCERS) {
          const int r = q >> 2;
          const int c = q & 3;
          const int src = idx[r];
          const __nv_bfloat16* g =
              col + (int64_t)(src < 0 ? 0 : src) * cin + c * 8;
          cp_async16(a_addr + r * ROW_BYTES + ((c ^ ((r >> 1) & 3)) << 4), g,
                     src < 0 ? 0u : 16u);
        }
        cp_async_arrive(bar);
        if (++slot == stages) {
          slot = 0;
          phase ^= 1u;
          refill = true;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumer warpgroups
  const int wg = tid / 128;
  const int n_steps = n_offsets * n_slices;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  int slot = 0, prev_slot = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_steps; ++t) {
    mbar_wait(full_bar + 8 * slot, phase);
    fence_proxy_async();   // the rows came through the generic proxy
    const uint32_t a_addr =
        ring_addr + slot * STAGE_BYTES + wg * (64 * ROW_BYTES);
    const uint64_t da = tile_desc(a_addr);
    const uint64_t db = tile_desc(ring_addr + slot * STAGE_BYTES + A_BYTES);
    wgmma_fence();
    Wgmma<BN>::mma(acc, da, db);
    Wgmma<BN>::mma(acc, da + 2, db + 2);   // second 16 channels: +32 bytes
    wgmma_commit();
    wgmma_wait<1>();       // step t - 1 has retired: its slot may be refilled
    if (t > 0 && tid % 128 == 0) mbar_arrive(empty_bar + 8 * prev_slot);
    prev_slot = slot;
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
  wgmma_wait<0>();
  consumer_sync<NWG * 128>();   // every read of the ring is over

  __nv_bfloat16* tile = (__nv_bfloat16*)ring;
  {
    const int t = tid % 128;
    const int r = wg * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int c = 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *(__nv_bfloat162*)&tile[r * OUT_STRIDE + 8 * j + c] =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *(__nv_bfloat162*)&tile[(r + 8) * OUT_STRIDE + 8 * j + c] =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  consumer_sync<NWG * 128>();
  constexpr int CHUNKS = BN / 8;   // 16-byte chunks per output row
  for (int q = tid; q < BM * CHUNKS; q += NWG * 128) {
    const int r = q / CHUNKS;
    const int c = q - r * CHUNKS;
    const int row = row0 + r;
    if (row < v_out)
      *(uint4*)&out[(int64_t)row * cout + split * BN + c * 8] =
          *(const uint4*)&tile[r * OUT_STRIDE + c * 8];
  }
}

// The weight images the conv kernel copies into its B tiles: for offset k,
// column split j and K slice s one tile of bn rows (output channels) x 32
// input channels, K-major in the 64-byte swizzle (see the top of the file).
// One thread per 16-byte chunk.  `w` is (27, cin, cout); with `mirror` it
// is (27, cout, cin) and the tile is that of W.flip(0).transpose(1, 2), the
// weights of the conv's input gradient.
__global__ void pack_weight_kernel(const __nv_bfloat16* __restrict__ w,
                                   __nv_bfloat16* __restrict__ wpack, int cin,
                                   int cout, int bn, int mirror) {
  const int chunk = blockIdx.x * blockDim.x + threadIdx.x;
  if (chunk >= N_OFFSETS * cout * (cin / 8)) return;
  const int n_slices = cin / BK;
  const int p = chunk & 3;
  int rest = chunk >> 2;
  const int n = rest % bn;
  rest /= bn;
  const int slice = rest % n_slices;
  rest /= n_slices;
  const int split = rest % (cout / bn);
  const int k = rest / (cout / bn);
  const int c = p ^ ((n >> 1) & 3);
  const int col = split * bn + n;          // output channel
  const int ch = slice * BK + c * 8;       // first of 8 input channels
  __align__(16) __nv_bfloat16 v[8];
  if (mirror) {
    const __nv_bfloat16* src =
        w + ((int64_t)(N_OFFSETS - 1 - k) * cout + col) * cin + ch;
    *(uint4*)v = *(const uint4*)src;
  } else {
    const __nv_bfloat16* src = w + ((int64_t)k * cin + ch) * cout + col;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = src[(int64_t)e * cout];
  }
  *(uint4*)&wpack[(int64_t)chunk * 8] = *(const uint4*)v;
}

template <int BN, int NWG, int PRODUCERS>
int launch(const void* feats, const void* wpack, const void* rule, void* out,
           int v_out, int n_live, int cin, int cout, int stages,
           int smem_bytes, cudaStream_t stream) {
  auto kernel = subm_conv_wgmma_kernel<BN, NWG, PRODUCERS>;
  // above 48 KB a kernel must be granted its dynamic shared memory; the
  // grant is per device, so it is renewed at every launch
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((v_out + 64 * NWG - 1) / (64 * NWG), cout / BN);
  kernel<<<grid, NWG * 128 + PRODUCERS, smem_bytes, stream>>>(
      (const __nv_bfloat16*)feats, (const __nv_bfloat16*)wpack,
      (const int32_t*)rule, (__nv_bfloat16*)out, v_out, n_live, cin, cout,
      stages);
  return (int)cudaGetLastError();
}

}  // namespace

// w: (27, cin, cout) bf16, or with `mirror` (27, cout, cin); wpack:
// 27 * cin * cout bf16, laid out as ops/subm_conv.py:pack_weight says.
extern "C" int tl_pack_weight(const void* w, void* wpack, int cin, int cout,
                              int bn, int mirror, void* stream) {
  if (cin % BK != 0 || bn <= 0 || cout % bn != 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = N_OFFSETS * cout * (cin / 8);
  pack_weight_kernel<<<(chunks + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)w, (__nv_bfloat16*)wpack, cin, cout, bn, mirror);
  return (int)cudaGetLastError();
}

// feats (V_in, cin) bf16; wpack: the weight images of tl_pack_weight;
// rule (27, v_out) int32; out (v_out, cout) bf16.
// bm, bn, stages, producers, smem_bytes: the plan of
// ops/subm_conv.py:conv_plan.
extern "C" int tl_subm_conv_wgmma(const void* feats, const void* wpack,
                                  const void* rule, void* out, int v_out,
                                  int n_live, int cin, int cout, int bm,
                                  int bn, int stages, int producers,
                                  int smem_bytes, void* stream) {
  if (cin % BK != 0 || bn <= 0 || cout % bn != 0 || stages < 2 ||
      stages > MAX_STAGES || (producers != 128 && producers != 256))
    return (int)cudaErrorInvalidValue;
  // the epilogue's padded output tile reuses the ring
  if (bm * (bn + 8) * 2 > stages * (bm + bn) * ROW_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define TL_CASE(BM, NWG, BN, PRODUCERS)                                     \
  if (bm == BM && bn == BN && producers == PRODUCERS)                       \
    return launch<BN, NWG, PRODUCERS>(feats, wpack, rule, out, v_out,       \
                                      n_live, cin, cout, stages,            \
                                      smem_bytes, s);
#define TL_BOTH(BN) TL_CASE(64, 1, BN, 128) TL_CASE(64, 1, BN, 256)
  // the tiles conv_plan chooses: 64 rows x any width with 4 or 8 producer
  // warps, 128 rows x 32 (huge grids only) with 4
  TL_BOTH(32)
  TL_BOTH(64)
  TL_BOTH(96)
  TL_BOTH(128)
  TL_BOTH(160)
  TL_BOTH(192)
  TL_BOTH(224)
  TL_BOTH(256)
  TL_CASE(128, 2, 32, 128)
#undef TL_BOTH
#undef TL_CASE
  return (int)cudaErrorInvalidValue;
}

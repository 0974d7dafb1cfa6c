// Submanifold sparse convolution as a bf16 gather-GEMM on the tensor cores.
//
// Replaces the Pallas kernel _subm_kernel + _gather_bands
// (treelearn_tpu/ops/pallas_conv.py:304,181, subm_conv_banded :355) for
// every bf16 conv of the port: any offset count up to 343 (kernel_size 7;
// 27 at kernel_size 3, 125 at 5) and any Cin and Cout in multiples of 8
// (ops/subm_conv.py zero-pads other widths first); it is also the conv's
// input gradient (the conv with the mirrored weights).  The TPU kernel
// takes any Cin up to 512 by padding it to 32..512 lanes
// (pallas_conv.py:122-127); here a narrow Cin costs nothing extra.
//
//   out[i] = sum_k feats[rule[k, i]] @ W[k]      (rule -1: no input)
//   bf16 in, float32 sums, bf16 out, rows i >= n_live are zeros
//
// Bound on the card: the arithmetic is tiny against the tensor-core rate
// (16..224 channels), so what a launch costs is the gather of 32..448-byte
// feature rows through L2 and, at the deepest levels, the latency of one
// block's walk over its K steps.  The design follows from that:
//
// * A block owns BM = 64 output voxels (one consumer warpgroup; two and 128
//   for 32-channel convs over very many voxels) and BN output channels, BN
//   any multiple of 8 up to 256: the whole Cout where it fits, so every
//   gathered row is read once per block.  Small levels split Cout into 32-
//   (or 16- or 8-) channel blocks to fill the card (ops/subm_conv.py:
//   conv_plan decides).  It is output-stationary: float32 accumulators stay
//   in registers, nothing is added atomically, and two launches give the
//   same bits.
// * K loop = (offsets that some row of the tile uses) x (Cin in slices of
//   BK = 32 channels, the last one 16 wide where Cin % 32 is 8 or 16).  The
//   offset count is a launch argument; the block's rule tile (n_offsets x
//   BM entries) lies in shared memory, so at K = 343 the plan gives up ring
//   slots, then rows, to fit.  Rows that lack a present offset, and the
//   8-channel chunks of a slice past Cin, are zero rows of A (zero-fill
//   copies that read nothing), and the weight images hold zeros there.
// * A (gathered rows) comes in by 16-byte cp.async, zero-fill form for
//   rule -1; B (the weight tile) is a packed image that ops/subm_conv.py
//   prepared in exactly the shared-memory layout below, so it is copied
//   linearly.  Both are K-major.  A 32-channel slice has 64-byte rows in the
//   64-byte swizzle (the 16-byte chunk c of row r lies at
//   r * 64 + ((c ^ ((r >> 1) & 3)) << 4), two k16 steps); the 16-channel
//   tail slice 32-byte rows in the 32-byte swizzle (chunk c of row r at
//   r * 32 + ((c ^ ((r >> 2) & 1)) << 4), one k16 step).  A slot is laid out
//   for a 32-channel slice; the tail uses the first half of its A and B
//   tiles, which keep their alignment for either swizzle.
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
//   step's wgmma (two k16 on a 32-channel slice, one on the tail), and
//   releases the previous step's slot once wgmma.wait_group says it has
//   retired.
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

constexpr int BK = 32;                 // input channels of a full K slice
constexpr int ROW_BYTES = BK * 2;      // one K-major row of its tile
constexpr int TAIL_BYTES = 32;         // one row of the 16-channel tail's
constexpr int MAX_STAGES = 8;
constexpr int MAX_OFFSETS = 343;       // kernel_size 7

// Shared-memory matrix descriptor of a K-major tile with `row_bytes`-byte
// rows in the swizzle of that width (64: a full slice, 32: the tail):
// 8-row groups 8 rows apart; the leading offset is not used by swizzled
// K-major layouts.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr, int row_bytes) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(8 * row_bytes >> 4) << 32;
  d |= (uint64_t)(row_bytes == ROW_BYTES ? 2 : 3) << 62;
  return d;
}

// Slices of a Cin: full 32-channel ones, then a 16-channel tail where the
// rest is 8 or 16 channels (a rest of 24 takes a full slice, its last chunk
// zero).  `kpad`: the channels of one weight-image row.
struct Slices {
  int n, kpad;
  bool tail;
  __host__ __device__ explicit Slices(int cin) {
    n = (cin + BK - 1) / BK;
    tail = cin % BK != 0 && cin % BK <= 16;
    kpad = tail ? (n - 1) * BK + 16 : n * BK;
  }
};

// BN: output channels per block; NWG: consumer warpgroups of 64 output rows
// each; PRODUCERS (128 or 256) more threads produce.  Dynamic shared memory,
// from a 1024-byte aligned base:
//   ring      stages x (A tile BM x 64 B, B tile BN x 64 B)
//   full[8], empty[8] mbarriers
//   rule_s    n_offsets x BM int32, -1 for no input and for rows past n_live
//   k_list    the present offsets, then their count; present[n_offsets]
template <int BN, int NWG, int PRODUCERS>
__global__ void __launch_bounds__(NWG * 128 + PRODUCERS, 1)
subm_conv_wgmma_kernel(const __nv_bfloat16* __restrict__ feats,
                       const __nv_bfloat16* __restrict__ wpack,
                       const int32_t* __restrict__ rule,
                       __nv_bfloat16* __restrict__ out, int v_out, int n_live,
                       int cin, int cout, int n_offsets, int stages) {
  constexpr int BM = 64 * NWG;
  constexpr int NT = 128 * NWG + PRODUCERS;
  constexpr int A_BYTES = BM * ROW_BYTES;
  constexpr int STAGE_BYTES = A_BYTES + BN * ROW_BYTES;
  constexpr int OUT_STRIDE = BN + 8;   // bf16 values; +8 spreads the banks

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t ring_addr = smem_u32(ring);
  uint8_t* after_ring = ring + (size_t)stages * STAGE_BYTES;
  const uint32_t full_bar = smem_u32(after_ring);       // + 8 * slot
  const uint32_t empty_bar = full_bar + 8 * MAX_STAGES;
  int32_t* rule_s = (int32_t*)(after_ring + 16 * MAX_STAGES);
  int* k_list = (int*)(rule_s + n_offsets * BM);   // offsets, then count
  int* present = k_list + n_offsets + 1;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const Slices sl(cin);

  for (int e = tid; e < n_offsets; e += NT) present[e] = 0;
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
  for (int e = tid; e < n_offsets * BM; e += NT) {
    const int k = e / BM;
    const int row = row0 + (e - k * BM);
    int src = -1;
    if (row < v_out && row < n_live) src = rule[(int64_t)k * v_out + row];
    rule_s[e] = src;
    if (src >= 0) present[k] = 1;
  }
  __syncthreads();
  if (tid < 32) {   // compact the present offsets, in order, 32 at a time
    int count = 0;
    for (int base = 0; base < n_offsets; base += 32) {
      const int k = base + tid;
      const bool on = k < n_offsets && present[k];
      const unsigned mask = __ballot_sync(0xffffffffu, on);
      if (on) k_list[count + __popc(mask & ((1u << tid) - 1u))] = k;
      count += __popc(mask);
    }
    if (tid == 0) k_list[n_offsets] = count;
  }
  __syncthreads();
  const int n_present = k_list[n_offsets];

  if (tid >= NWG * 128) {
    // ---- producer warps: fill the ring, never touch the output
    const int p = tid - NWG * 128;
    int slot = 0, step = 0;
    uint32_t phase = 0;
    bool refill = false;   // the ring has gone round: wait for the consumers
    for (int ki = 0; ki < n_present; ++ki) {
      const int k = k_list[ki];
      const int32_t* idx = rule_s + k * BM;
      const __nv_bfloat16* image =
          wpack + ((int64_t)k * n_splits + split) * BN * sl.kpad;
      for (int slice = 0; slice < sl.n; ++slice) {
        const bool half = sl.tail && slice == sl.n - 1;
        if (refill) mbar_wait(empty_bar + 8 * slot, phase ^ 1u);
        const uint32_t a_addr = ring_addr + slot * STAGE_BYTES;
        const uint32_t bar = full_bar + 8 * slot;
        // the warps take turns at the weight tile: starting it costs about
        // as much as a warp's row copies
        if (p == 32 * (step++ % (PRODUCERS / 32))) {
          const uint32_t b_bytes = BN * (half ? TAIL_BYTES : ROW_BYTES);
          mbar_expect_tx(bar, b_bytes);
          bulk_copy(a_addr + A_BYTES, image + slice * (BN * BK), b_bytes, bar);
        }
        const __nv_bfloat16* col = feats + slice * BK;
        const int left = cin - slice * BK;   // channels of this slice
        if (!half) {
#pragma unroll
          for (int q = p; q < BM * 4; q += PRODUCERS) {
            const int r = q >> 2;
            const int c = q & 3;
            const int src = idx[r];
            const bool ok = src >= 0 && c * 8 < left;
            const __nv_bfloat16* g =
                col + (ok ? (int64_t)src * cin + c * 8 : 0);
            cp_async16(a_addr + r * ROW_BYTES + ((c ^ ((r >> 1) & 3)) << 4),
                       g, ok ? 16u : 0u);
          }
        } else {
#pragma unroll
          for (int q = p; q < BM * 2; q += PRODUCERS) {
            const int r = q >> 1;
            const int c = q & 1;
            const int src = idx[r];
            const bool ok = src >= 0 && c * 8 < left;
            const __nv_bfloat16* g =
                col + (ok ? (int64_t)src * cin + c * 8 : 0);
            cp_async16(a_addr + r * TAIL_BYTES + ((c ^ ((r >> 2) & 1)) << 4),
                       g, ok ? 16u : 0u);
          }
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
  const int n_steps = n_present * sl.n;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  int slot = 0, prev_slot = 0, slice = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_steps; ++t) {
    const bool half = sl.tail && slice == sl.n - 1;
    const int row_bytes = half ? TAIL_BYTES : ROW_BYTES;
    mbar_wait(full_bar + 8 * slot, phase);
    fence_proxy_async();   // the rows came through the generic proxy
    const uint32_t a_addr =
        ring_addr + slot * STAGE_BYTES + wg * (64 * row_bytes);
    const uint64_t da = tile_desc(a_addr, row_bytes);
    const uint64_t db =
        tile_desc(ring_addr + slot * STAGE_BYTES + A_BYTES, row_bytes);
    wgmma_fence();
    Wgmma<BN>::mma(acc, da, db);
    if (!half)   // second 16 channels: +32 bytes
      Wgmma<BN>::mma(acc, da + 2, db + 2);
    wgmma_commit();
    wgmma_wait<1>();       // step t - 1 has retired: its slot may be refilled
    if (t > 0 && tid % 128 == 0) mbar_arrive(empty_bar + 8 * prev_slot);
    prev_slot = slot;
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
    if (++slice == sl.n) slice = 0;
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

// The weight images the conv kernel copies into its B tiles: for offset k
// and column split j one image of bn rows (output channels) x kpad input
// channels, made of one tile per K slice (Slices above): bn x 32 channels
// K-major in the 64-byte swizzle, the 16-channel tail bn x 16 in the
// 32-byte swizzle; channels past cin are zeros.  One thread per 16-byte
// chunk.  `w` is (n_offsets, cin, cout); with `mirror` it is (n_offsets,
// cout, cin) and the image is that of W.flip(0).transpose(1, 2), the
// weights of the conv's input gradient.
__global__ void pack_weight_kernel(const __nv_bfloat16* __restrict__ w,
                                   __nv_bfloat16* __restrict__ wpack, int cin,
                                   int cout, int bn, int n_offsets,
                                   int mirror) {
  const Slices sl(cin);
  const int per_image = bn * sl.kpad / 8;   // chunks of one (k, j) image
  const int64_t chunk = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (chunk >= (int64_t)n_offsets * (cout / bn) * per_image) return;
  const int pos = (int)(chunk % per_image);
  const int64_t rest = chunk / per_image;
  const int split = (int)(rest % (cout / bn));
  const int k = (int)(rest / (cout / bn));
  const int full = sl.tail ? sl.n - 1 : sl.n;
  int n, ch;
  if (pos < full * bn * 4) {
    const int slice = pos / (bn * 4);
    const int q = pos - slice * bn * 4;
    n = q >> 2;
    ch = slice * BK + (((q & 3) ^ ((n >> 1) & 3)) << 3);
  } else {
    const int q = pos - full * bn * 4;
    n = q >> 1;
    ch = full * BK + (((q & 1) ^ ((n >> 2) & 1)) << 3);
  }
  const int col = split * bn + n;          // output channel
  __align__(16) __nv_bfloat16 v[8];
  if (ch >= cin) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(0.f);
  } else if (mirror) {
    const __nv_bfloat16* src =
        w + ((int64_t)(n_offsets - 1 - k) * cout + col) * cin + ch;
    *(uint4*)v = *(const uint4*)src;
  } else {
    const __nv_bfloat16* src = w + ((int64_t)k * cin + ch) * cout + col;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = src[(int64_t)e * cout];
  }
  *(uint4*)&wpack[chunk * 8] = *(const uint4*)v;
}

template <int BN, int NWG, int PRODUCERS>
int launch(const void* feats, const void* wpack, const void* rule, void* out,
           int v_out, int n_live, int cin, int cout, int n_offsets,
           int stages, int smem_bytes, cudaStream_t stream) {
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
      n_offsets, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// w: (n_offsets, cin, cout) bf16, or with `mirror` (n_offsets, cout, cin);
// wpack: n_offsets * cout * kpad bf16 (kpad: cin rounded up to its slices),
// laid out as ops/subm_conv.py:pack_weight says.
extern "C" int tl_pack_weight(const void* w, void* wpack, int cin, int cout,
                              int bn, int n_offsets, int mirror,
                              void* stream) {
  if (cin <= 0 || cin % 8 != 0 || bn <= 0 || bn % 8 != 0 || cout % bn != 0 ||
      n_offsets < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t chunks = (int64_t)n_offsets * cout * Slices(cin).kpad / 8;
  pack_weight_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0,
                       (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)w, (__nv_bfloat16*)wpack, cin, cout, bn,
      n_offsets, mirror);
  return (int)cudaGetLastError();
}

// feats (V_in, cin) bf16; wpack: the weight images of tl_pack_weight;
// rule (n_offsets, v_out) int32; out (v_out, cout) bf16.
// bm, bn, stages, producers, smem_bytes: the plan of
// ops/subm_conv.py:conv_plan.
extern "C" int tl_subm_conv_wgmma(const void* feats, const void* wpack,
                                  const void* rule, void* out, int v_out,
                                  int n_live, int cin, int cout,
                                  int n_offsets, int bm, int bn, int stages,
                                  int producers, int smem_bytes,
                                  void* stream) {
  if (cin <= 0 || cin % 8 != 0 || bn <= 0 || cout % bn != 0 || stages < 2 ||
      stages > MAX_STAGES || (producers != 128 && producers != 256) ||
      n_offsets < 1 || n_offsets > MAX_OFFSETS)
    return (int)cudaErrorInvalidValue;
  // the epilogue's padded output tile reuses the ring
  if (bm * (bn + 8) * 2 > stages * (bm + bn) * ROW_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define TL_CASE(BM, NWG, BN, PRODUCERS)                                     \
  if (bm == BM && bn == BN && producers == PRODUCERS)                       \
    return launch<BN, NWG, PRODUCERS>(feats, wpack, rule, out, v_out,       \
                                      n_live, cin, cout, n_offsets, stages, \
                                      smem_bytes, s);
#define TL_BOTH(BN) TL_CASE(64, 1, BN, 128) TL_CASE(64, 1, BN, 256)
  // the tiles conv_plan chooses (ops/subm_conv.py:BF16_BN): 64 rows x any
  // width with 4 or 8 producer warps, 128 rows x 32 (huge grids only) with 4
  TL_BOTH(8)
  TL_BOTH(16)
  TL_BOTH(24)
  TL_BOTH(32)
  TL_BOTH(40)
  TL_BOTH(48)
  TL_BOTH(56)
  TL_BOTH(64)
  TL_BOTH(80)
  TL_BOTH(96)
  TL_BOTH(112)
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

// Masked cross-attention of SPFormer's query decoder on the tensor cores:
// Q queries against one batch element's K keys in H heads of width 32,
// under a mask set from the previous prediction's mask logits P (Q, K).
//
// Replaces no TPU kernel: the JAX package has no SPFormer head.  It takes
// the place of PyTorch's memory-efficient SDPA under an additive bf16 mask
// (fmha_cutlassF / fmha_cutlassB), which at Q 400, K ~200,000 spread its
// backward over batch x heads = 8 blocks, walked every key for every query
// and read a 2-byte mask entry a pair (160 MB a call, kept by autograd).
//
//   open(q, k) = !(P[q, k] < 0)   (0, -0.0 and NaN open), a row with no open
//                                  key opened whole (model/spformer.py:
//                                  closed_mask)
//   O = softmax(scale Q K^T | open) V,   scale = 32^-0.5, per head
//   bf16 operands, float32 scores, statistics and sums, bf16 O, dQ, dK, dV
//
// Bound on the card: at head width 32 the products are small for the
// tensor cores (4 x 32 operations a pair and head forward, 10 x 32
// backward); what bounds a call is the softmax's exponentials, ~1.3e9 of
// them forward and backward at the cell's shape, ~0.35 ms at the SFU's 16
// a clock on 132 SMs, then the keys' bytes (K x 2 x 256 bf16, ~0.2 GB a
// call, read once by forward and backward).  The design follows:
//
// * The mask is packed once a prediction from P (tl_mask_attn_pack): one
//   bit a pair, 1 = open (a warp's ballot over 32 keys is one word), rows
//   W = 4 ceil(K / 128) words wide; an all-closed row gets every bit of its
//   K keys; one byte a (64-query, 64-key) tile says whether the tile has an
//   open pair; the open pairs are counted on the card.  The bits are 1/16
//   of the old additive mask; the attention reads 8 bytes a row and block.
// * Few queries, many keys: Q = 400 is 7 query tiles of 64, x 8 heads = 56
//   units, too few for 132 SMs, so the keys are split.  Forward: a block
//   owns one (query tile, head) over a range of key blocks and keeps the
//   flash recurrence (running max and sum, float32 O in registers); it
//   writes its partial O and (max, sum); a combine kernel merges the
//   splits in split order and writes O (Q, D) bf16 and the log2-domain
//   LSE.  Backward: a block owns one head's range of key blocks, holds
//   that head's Q and dO (Q <= 512 rows of 64 bytes each), LSE and
//   delta = rowsum(dO O) in shared memory, recomputes P for every live
//   (key block, query tile) and writes dK and dV of its keys once (no
//   atomics); its dQ over its keys is a float32 partial in shared memory,
//   which a reduce kernel sums over the ranges in range order.  Every sum
//   has a fixed order: two launches give the same bits.
// * A tile with no open pair is skipped: the forward walks only its query
//   tile's live key blocks, the backward only the live query tiles of a
//   key block (a key block with none writes zero gradients and is not
//   read).
// * K and V are read in place from the key/value projection, rows of 2 D
//   bf16 (the head's 64-byte slice of each), by 16-byte cp.async, rows past
//   K zero-filled; no slice is copied and no head is transposed.
// * Products (wgmma, bf16 -> float32): a 32-wide bf16 row is 64 bytes, so
//   every tile (Q, K, V, dO, dS^T) has 64-byte rows in the 64-byte swizzle
//   (chunk c of row r at r * 64 + ((c ^ ((r >> 1) & 3)) << 4)) and serves
//   as a K-major operand (rows are M or N, the head width the reduction)
//   or an MN-major one (rows are the reduction, 16 rows a k16 step of 1024
//   bytes).  S = Q K^T and dP^T = V dO^T: both K-major.  O += P V, dV +=
//   P^T dO and dK += dS^T Q: P (resp. P^T, dS^T) from registers (the
//   accumulator layout of one product is the A fragment of the next, for
//   16-bit types), the other operand MN-major.  dQ = dS K: dS^T written to
//   shared memory as rows of keys (MN-major A), K MN-major.
//
// The inline-PTX wrappers (copies, fences, wgmma) are in wgmma.cuh.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include "wgmma.cuh"

namespace {

constexpr int HD = 32;               // head width
constexpr int TQ = 64;               // queries of a tile
constexpr int TK = 64;               // keys of a block
constexpr int ROW = 64;              // bytes of a 32-wide bf16 row
constexpr int TILE = 64 * ROW;       // 64 rows
constexpr int MAX_QT = 8;            // query tiles: Q <= 512
constexpr int FWD_STAGES = 3;
constexpr int FWD_STAGE_BYTES = 2 * TILE + 1024;   // K, V, 64 rows of bits
constexpr int PACK_GROUPS = 4;       // 32-word groups of a pack block
constexpr float NEG_INF = -INFINITY;

__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * ROW + ((c ^ ((r >> 1) & 3)) << 4);
}

// K-major operand: 64-byte rows, 8-row groups 512 bytes apart
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(8 * ROW >> 4) << 32;
  d |= (uint64_t)2 << 62;
  return d;
}
// MN-major operand whose first reduction row lies at `addr`: 32-wide
// slabs `slab` bytes apart, 8-row groups 512 bytes apart
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, uint32_t slab) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)(slab >> 4) << 16;
  d |= (uint64_t)(8 * ROW >> 4) << 32;
  d |= (uint64_t)2 << 62;
  return d;
}

// wgmma m64n32k16, A (64 x 16 bf16) from registers in the A-fragment
// layout (thread t: rows 16 (t / 32) + (t % 32) / 4 (+ 8), columns
// 2 (t % 4) (+ 1) (+ 8): a[0] = (r, c), a[1] = (r + 8, c), a[2] = (r, c + 8),
// a[3] = (r + 8, c + 8), two bf16 each), B MN-major from shared memory
__device__ __forceinline__ void wgmma_rs32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" REGS_32 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ACCS_32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// 8 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *(uint32_t*)&v;
}

// The A fragments of a 64 x 64 product's accumulators (8-column blocks j,
// d[4 j .. 4 j + 3] as wgmma.cuh describes) for its four k16 steps.
__device__ __forceinline__ void a_fragments(const float (&d)[32],
                                            uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}
__device__ __forceinline__ void keep(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(a[kk][e]);
}
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(d[i]);
}

// ---- packing

// Grid (query tiles, chunks of PACK_GROUPS x 32 words), 256 threads: warp w
// takes rows w, w + 8, ... of the tile; for each 32-word group lane l reads
// key 32 i + l of word i in turn and keeps word l.  Writes the bits, the
// tile bytes of the chunk's key blocks and each row's open count over the
// chunk (count_part[row][chunk]).
__global__ void __launch_bounds__(256)
mask_attn_pack_kernel(const float* __restrict__ p, uint32_t* __restrict__ bits,
                      uint8_t* __restrict__ tiles, int* __restrict__ count_part,
                      int nq, int nk, int words) {
  __shared__ uint8_t flags[PACK_GROUPS * 16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = blockIdx.x, chunk = blockIdx.y, n_chunks = gridDim.y;
  const int w0 = chunk * PACK_GROUPS * 32;
  const int n_kb = (nk + TK - 1) / TK;
  if (tid < PACK_GROUPS * 16) flags[tid] = 0;
  __syncthreads();
  for (int r = warp; r < TQ; r += 8) {
    const int row = qt * TQ + r;
    if (row >= nq) break;
    const float* prow = p + (int64_t)row * nk;
    int count = 0;
#pragma unroll 1
    for (int g = 0; g < PACK_GROUPS; ++g) {
      const int wg = w0 + g * 32;
      uint32_t mine = 0;
#pragma unroll 4
      for (int i = 0; i < 32; ++i) {
        const int key = (wg + i) * 32 + lane;
        const bool open = key < nk && !(prow[key] < 0.f);
        const uint32_t word = __ballot_sync(0xffffffffu, open);
        if (lane == i) mine = word;
      }
      if (wg + lane < words) bits[(int64_t)row * words + wg + lane] = mine;
      count += __popc(mine);
      // words 2 b and 2 b + 1 are key block b
      const uint32_t pair = mine | __shfl_xor_sync(0xffffffffu, mine, 1);
      if ((lane & 1) == 0 && pair != 0u) flags[g * 16 + lane / 2] = 1;
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      count += __shfl_xor_sync(0xffffffffu, count, s);
    if (lane == 0) count_part[(int64_t)row * n_chunks + chunk] = count;
  }
  __syncthreads();
  if (tid < PACK_GROUPS * 16) {
    const int kb = w0 / 2 + tid;
    if (kb < n_kb) tiles[(int64_t)qt * n_kb + kb] = flags[tid];
  }
}

// One block a row: the row's open count in chunk order; a row with none is
// opened whole (every bit of its keys set, its query tile's bytes all 1).
__global__ void __launch_bounds__(256)
mask_attn_pack_fix_kernel(uint32_t* __restrict__ bits,
                          uint8_t* __restrict__ tiles,
                          const int* __restrict__ count_part,
                          int* __restrict__ row_open,
                          uint8_t* __restrict__ row_closed, int nk, int words,
                          int n_chunks) {
  __shared__ int total;
  const int row = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) {
    int s = 0;
    for (int c = 0; c < n_chunks; ++c) s += count_part[(int64_t)row * n_chunks + c];
    total = s;
    row_open[row] = s > 0 ? s : nk;
    row_closed[row] = s == 0;
  }
  __syncthreads();
  if (total > 0) return;
  for (int w = tid; w < words; w += blockDim.x) {
    const int left = nk - 32 * w;
    bits[(int64_t)row * words + w] =
        left >= 32 ? 0xffffffffu : (left > 0 ? (1u << left) - 1u : 0u);
  }
  const int n_kb = (nk + TK - 1) / TK;
  for (int kb = tid; kb < n_kb; kb += blockDim.x)
    tiles[(int64_t)(row / TQ) * n_kb + kb] = 1;
}

// One block: stats = (open pairs, tiles with no open pair, tiles).
__global__ void __launch_bounds__(1024)
mask_attn_pack_stats_kernel(const int* __restrict__ row_open,
                            const uint8_t* __restrict__ tiles,
                            int64_t* __restrict__ stats, int nq,
                            int64_t n_tiles) {
  __shared__ unsigned long long sums[2];
  const int tid = threadIdx.x;
  if (tid < 2) sums[tid] = 0ull;
  __syncthreads();
  unsigned long long open = 0, empty = 0;
  for (int r = tid; r < nq; r += blockDim.x) open += (unsigned)row_open[r];
  for (int64_t t = tid; t < n_tiles; t += blockDim.x) empty += tiles[t] == 0;
  atomicAdd(&sums[0], open);
  atomicAdd(&sums[1], empty);
  __syncthreads();
  if (tid == 0) {
    stats[0] = (int64_t)sums[0];
    stats[1] = (int64_t)sums[1];
    stats[2] = n_tiles;
  }
}

// ---- forward

// Grid (query tiles, heads, splits), 128 threads (one warpgroup).  Dynamic
// shared memory from a 1024-byte aligned base: the Q tile, FWD_STAGES
// slots of (K tile, V tile, the 64 rows' two bit words of the block), the
// split's live key blocks.
__global__ void __launch_bounds__(128)
mask_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ kv,
                     const uint32_t* __restrict__ bits,
                     const uint8_t* __restrict__ tiles,
                     float* __restrict__ o_part, float* __restrict__ ml_part,
                     int nq, int nk, int words, int heads,
                     int blocks_per_split, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base_ptr = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t q_addr = smem_u32(base_ptr);
  const uint32_t ring_addr = q_addr + TILE;
  uint8_t* ring = base_ptr + TILE;
  int* list = (int*)(ring + FWD_STAGES * FWD_STAGE_BYTES);
  __shared__ int n_live_s;

  const int tid = threadIdx.x;
  const int qt = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int d_model = heads * HD;
  const int n_kb = (nk + TK - 1) / TK;
  const int kb0 = split * blocks_per_split;
  const int kb1 = min(n_kb, kb0 + blocks_per_split);

  if (tid < 32) {   // the live key blocks of the range, in order
    int count = 0;
    for (int b0 = kb0; b0 < kb1; b0 += 32) {
      const int kb = b0 + tid;
      const bool on = kb < kb1 && tiles[(int64_t)qt * n_kb + kb] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (on) list[count + __popc(m & ((1u << tid) - 1u))] = kb;
      count += __popc(m);
    }
    if (tid == 0) n_live_s = count;
  }
  for (int e = tid; e < TQ * 4; e += 128) {
    const int r = e >> 2, c = e & 3, row = qt * TQ + r;
    const bool ok = row < nq;
    cp_async16(q_addr + swz(r, c),
               q + (ok ? (int64_t)row * d_model + h * HD + c * 8 : 0),
               ok ? 16u : 0u);
  }
  cp_async_commit();
  __syncthreads();
  const int n_live = n_live_s;

  auto load = [&](int slot, int kb) {
    const uint32_t s_addr = ring_addr + slot * FWD_STAGE_BYTES;
    for (int e = tid; e < TK * 4; e += 128) {
      const int r = e >> 2, c = e & 3, key = kb * TK + r;
      const bool ok = key < nk;
      const __nv_bfloat16* src =
          kv + (ok ? (int64_t)key * 2 * d_model + h * HD + c * 8 : 0);
      cp_async16(s_addr + swz(r, c), src, ok ? 16u : 0u);
      cp_async16(s_addr + TILE + swz(r, c), src + (ok ? d_model : 0),
                 ok ? 16u : 0u);
    }
    if (tid < TQ) {
      const int row = qt * TQ + tid;
      const bool ok = row < nq;
      cp_async8(s_addr + 2 * TILE + tid * 8,
                bits + (ok ? (int64_t)row * words + 2 * kb : 0),
                ok ? 8u : 0u);
    }
  };
#pragma unroll
  for (int s = 0; s < FWD_STAGES - 1; ++s) {
    if (s < n_live) load(s, list[s]);
    cp_async_commit();
  }

  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;   // rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);
  float o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  const uint64_t dq = kmajor_desc(q_addr);

  for (int t = 0; t < n_live; ++t) {
    const int slot = t % FWD_STAGES;
    cp_async_wait<FWD_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();   // block t landed; block t - 1's slot is free
    {
      const int nxt = t + FWD_STAGES - 1;
      if (nxt < n_live) load(nxt % FWD_STAGES, list[nxt]);
      cp_async_commit();
    }
    const uint32_t s_addr = ring_addr + slot * FWD_STAGE_BYTES;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint64_t dk = kmajor_desc(s_addr);
    wgmma_fence();
    Wgmma<64>::mma(s, dq, dk);
    Wgmma<64>::mma(s, dq + 2, dk + 2);
    wgmma_commit();
    wgmma_wait<0>();
    keep<32>(s);

    const uint2* bw = (const uint2*)(ring + slot * FWD_STAGE_BYTES + 2 * TILE);
    const uint2 b[2] = {bw[r0], bw[r0 + 8]};
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, col = 8 * j + c2 + (e & 1);
        const uint32_t word = col < 32 ? b[hh].x : b[hh].y;
        const float v = (word >> (col & 31)) & 1u ? s[4 * j + e] * scale_log2
                                                  : NEG_INF;
        s[4 * j + e] = v;
        mx[hh] = fmaxf(mx[hh], v);
      }
    float alpha[2], sub[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_run[hh], mx[hh]);
      sub[hh] = m_new == NEG_INF ? 0.f : m_new;
      alpha[hh] = ex2(m_run[hh] - sub[hh]);
      m_run[hh] = m_new;
      l_run[hh] *= alpha[hh];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const float pv = ex2(s[4 * j + e] - sub[hh]);
        s[4 * j + e] = pv;
        l_run[hh] += pv;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    uint32_t a[4][4];
    a_fragments(s, a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs32(o, a[kk], mn_desc(s_addr + TILE + kk * 1024, TILE));
    wgmma_commit();
    wgmma_wait<0>();
    keep(a);
    keep<16>(o);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 2);
    const int row = qt * TQ + r0 + 8 * hh;
    if (row >= nq) continue;
    const int64_t at = ((int64_t)split * heads + h) * nq + row;
    float* out = o_part + at * HD;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *(float2*)(out + 8 * j + c2) =
          make_float2(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
    if (lane % 4 == 0)
      *(float2*)(ml_part + 2 * at) = make_float2(m_run[hh], l_run[hh]);
  }
}

// A warp a (query, head), lane = channel: the splits merged in split order.
__global__ void __launch_bounds__(128)
mask_attn_fwd_combine_kernel(const float* __restrict__ o_part,
                             const float* __restrict__ ml_part,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int nq, int heads,
                             int n_splits) {
  const int wid = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wid >= nq * heads) return;
  const int row = wid / heads, h = wid % heads;
  float m = NEG_INF;
  for (int s = 0; s < n_splits; ++s)
    m = fmaxf(m, ml_part[2 * (((int64_t)s * heads + h) * nq + row)]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const int64_t at = ((int64_t)s * heads + h) * nq + row;
    const float ms = ml_part[2 * at];
    if (ms == NEG_INF) continue;
    const float w = exp2f(ms - m);
    l += ml_part[2 * at + 1] * w;
    acc += o_part[at * HD + lane] * w;
  }
  out[(int64_t)row * heads * HD + h * HD + lane] = __float2bfloat16(acc / l);
  if (lane == 0) lse[(int64_t)h * nq + row] = m + log2f(l);
}

// ---- backward

// A warp a (query, head): delta = rowsum(dO O) in float32.
__global__ void __launch_bounds__(128)
mask_attn_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                           const __nv_bfloat16* __restrict__ dout,
                           float* __restrict__ delta, int nq, int heads) {
  const int wid = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wid >= nq * heads) return;
  const int row = wid / heads, h = wid % heads;
  const int64_t at = (int64_t)row * heads * HD + h * HD + lane;
  float v = __bfloat162float(o[at]) * __bfloat162float(dout[at]);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  if (lane == 0) delta[(int64_t)h * nq + row] = v;
}

// Grid (heads, key ranges), 128 threads.  Dynamic shared memory from a
// 1024-byte aligned base: Q and dO of the head (n_qt tiles each), two
// slots of (K tile, V tile, the bit words of every query row for the
// block, 8 bytes a row), the dS^T tile (two 32-query slabs of 64 key rows),
// the float32 dQ partial (n_qt x 16 x 128, in accumulator order), LSE and
// delta (n_qt x 64 each), each block's live query tiles and the live list.
__global__ void __launch_bounds__(128, 1)
mask_attn_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ kv,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const uint32_t* __restrict__ bits,
                     const uint8_t* __restrict__ tiles,
                     __nv_bfloat16* __restrict__ dkv,
                     float* __restrict__ dq_part, int nq, int nk, int words,
                     int heads, int blocks_per_chunk, float scale_log2,
                     float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base_ptr = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int n_qt = (nq + TQ - 1) / TQ;
  const int q_pad = n_qt * TQ;
  const int bits_bytes = ((q_pad * 8 + 1023) / 1024) * 1024;
  const int slot_bytes = 2 * TILE + bits_bytes;
  uint8_t* q_s = base_ptr;
  uint8_t* do_s = q_s + n_qt * TILE;
  uint8_t* ring = do_s + n_qt * TILE;
  uint8_t* ds_s = ring + 2 * slot_bytes;
  float* dq_s = (float*)(ds_s + 2 * TILE);
  float* lse_s = dq_s + n_qt * 16 * 128;
  float* delta_s = lse_s + q_pad;
  uint8_t* qmask = (uint8_t*)(delta_s + q_pad);
  int* list = (int*)(qmask + ((blocks_per_chunk + 15) / 16) * 16);
  __shared__ int n_live_s;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, chunk = blockIdx.y;
  const int d_model = heads * HD;
  const int n_kb = (nk + TK - 1) / TK;
  const int kb0 = chunk * blocks_per_chunk;
  const int kb1 = min(n_kb, kb0 + blocks_per_chunk);
  const int n_blk = max(0, kb1 - kb0);
  const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s);
  const uint32_t ring_addr = smem_u32(ring), ds_addr = smem_u32(ds_s);

  for (int e = tid; e < n_qt * TQ * 4; e += 128) {
    const int r = e >> 2, c = e & 3;
    const bool ok = r < nq;
    const int64_t at = ok ? (int64_t)r * d_model + h * HD + c * 8 : 0;
    cp_async16(q_addr + swz(r, c), q + at, ok ? 16u : 0u);
    cp_async16(do_addr + swz(r, c), dout + at, ok ? 16u : 0u);
  }
  cp_async_commit();
  for (int r = tid; r < q_pad; r += 128) {
    lse_s[r] = r < nq ? lse[(int64_t)h * nq + r] : 0.f;
    delta_s[r] = r < nq ? delta[(int64_t)h * nq + r] : 0.f;
  }
  for (int e = tid; e < n_qt * 16 * 128; e += 128) dq_s[e] = 0.f;
  for (int e = tid; e < n_blk; e += 128) {
    unsigned m = 0;
    for (int i = 0; i < n_qt; ++i)
      m |= (tiles[(int64_t)i * n_kb + kb0 + e] != 0) << i;
    qmask[e] = (uint8_t)m;
  }
  __syncthreads();
  if (tid < 32) {
    int count = 0;
    for (int b0 = 0; b0 < n_blk; b0 += 32) {
      const bool on = b0 + tid < n_blk && qmask[b0 + tid] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (on) list[count + __popc(m & ((1u << tid) - 1u))] = kb0 + b0 + tid;
      count += __popc(m);
    }
    if (tid == 0) n_live_s = count;
  }
  // key blocks with no open pair: zero gradients, nothing read
  for (int e = tid; e < n_blk * TK * 8; e += 128) {
    const int blk = e / (TK * 8), rest = e % (TK * 8);
    if (qmask[blk]) continue;
    const int key = (kb0 + blk) * TK + rest / 8, c = rest % 8;
    if (key >= nk) continue;
    const int col = (c < 4 ? 0 : d_model) + h * HD + (c % 4) * 8;
    *(uint4*)(dkv + (int64_t)key * 2 * d_model + col) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  const int n_live = n_live_s;

  auto load = [&](int slot, int kb) {
    const uint32_t s_addr = ring_addr + slot * slot_bytes;
    for (int e = tid; e < TK * 4; e += 128) {
      const int r = e >> 2, c = e & 3, key = kb * TK + r;
      const bool ok = key < nk;
      const __nv_bfloat16* src =
          kv + (ok ? (int64_t)key * 2 * d_model + h * HD + c * 8 : 0);
      cp_async16(s_addr + swz(r, c), src, ok ? 16u : 0u);
      cp_async16(s_addr + TILE + swz(r, c), src + (ok ? d_model : 0),
                 ok ? 16u : 0u);
    }
    for (int r = tid; r < q_pad; r += 128) {
      const bool ok = r < nq;
      cp_async8(s_addr + 2 * TILE + r * 8,
                bits + (ok ? (int64_t)r * words + 2 * kb : 0), ok ? 8u : 0u);
    }
  };
  if (n_live > 0) load(0, list[0]);
  cp_async_commit();

  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;   // key rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);

  for (int t = 0; t < n_live; ++t) {
    const int slot = t & 1;
    const int kb = list[t];
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();   // block t landed; the other slot is free
    if (t + 1 < n_live) load(slot ^ 1, list[t + 1]);
    cp_async_commit();
    const uint32_t k_addr = ring_addr + slot * slot_bytes;
    const uint32_t v_addr = k_addr + TILE;
    const uint2* bw = (const uint2*)(ring + slot * slot_bytes + 2 * TILE);
    const unsigned live = qmask[kb - kb0];
    float dk[16], dv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dk[i] = dv[i] = 0.f;

    for (int i = 0; i < n_qt; ++i) {
      if (!((live >> i) & 1u)) continue;
      float s[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
      const uint32_t qi = q_addr + i * TILE, doi = do_addr + i * TILE;
      wgmma_fence();
      Wgmma<64>::mma(s, kmajor_desc(k_addr), kmajor_desc(qi));
      Wgmma<64>::mma(s, kmajor_desc(k_addr) + 2, kmajor_desc(qi) + 2);
      Wgmma<64>::mma(dp, kmajor_desc(v_addr), kmajor_desc(doi));
      Wgmma<64>::mma(dp, kmajor_desc(v_addr) + 2, kmajor_desc(doi) + 2);
      wgmma_commit();
      wgmma_wait<0>();
      keep<32>(s);
      keep<32>(dp);

      // rows: keys r0 + 8 hh; columns: queries 64 i + 8 j + c2 (+ 1)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int qc = i * TQ + 8 * j + c2 + e2;
          const uint2 w = bw[qc];
          const float lq = lse_s[qc], dl = delta_s[qc];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int key = r0 + 8 * hh;
            const uint32_t word = key < 32 ? w.x : w.y;
            const int at = 4 * j + 2 * hh + e2;
            const float pv = (word >> (key & 31)) & 1u
                                 ? ex2(s[at] * scale_log2 - lq)
                                 : 0.f;
            s[at] = pv;
            dp[at] = pv * (dp[at] - dl);
          }
        }
      uint32_t pa[4][4], da[4][4];
      a_fragments(s, pa);
      a_fragments(dp, da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs32(dv, pa[kk], mn_desc(doi + kk * 1024, TILE));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs32(dk, da[kk], mn_desc(qi + kk * 1024, TILE));
      wgmma_commit();
      // dS^T as rows of keys: query column qc of slab qc / 32
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = r0 + 8 * hh;
          *(uint32_t*)(ds_s + (j / 4) * TILE + swz(key, j & 3) + c2 * 2) =
              pack_bf16(dp[4 * j + 2 * hh], dp[4 * j + 2 * hh + 1]);
        }
      fence_proxy_async();
      __syncthreads();
      float dqa[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) dqa[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<32, 1>::mma(dqa, mn_desc(ds_addr + kk * 1024, TILE),
                          mn_desc(k_addr + kk * 1024, TILE));
      wgmma_commit();
      wgmma_wait<0>();
      keep(pa);
      keep(da);
      keep<16>(dk);
      keep<16>(dv);
      keep<16>(dqa);
      float* acc = dq_s + i * 16 * 128 + tid;
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e * 128] += dqa[e];
      __syncthreads();   // every read of dS^T is over
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = kb * TK + r0 + 8 * hh;
      if (key >= nk) continue;
      __nv_bfloat16* row = dkv + (int64_t)key * 2 * d_model + h * HD + c2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *(uint32_t*)(row + 8 * j) = pack_bf16(
            dk[4 * j + 2 * hh] * scale, dk[4 * j + 2 * hh + 1] * scale);
        *(uint32_t*)(row + d_model + 8 * j) =
            pack_bf16(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
      }
    }
  }
  cp_async_wait<0>();

  // this range's dQ: query rows 64 i + r0 (+ 8), channels 8 j + c2 (+ 1)
  for (int i = 0; i < n_qt; ++i) {
    const float* acc = dq_s + i * 16 * 128 + tid;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = i * TQ + r0 + 8 * hh;
      if (row >= nq) continue;
      float* out =
          dq_part + (((int64_t)chunk * heads + h) * nq + row) * HD + c2;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *(float2*)(out + 8 * j) =
            make_float2(acc[(4 * j + 2 * hh) * 128] * scale,
                        acc[(4 * j + 2 * hh + 1) * 128] * scale);
    }
  }
}

// dQ (Q, D) bf16: the ranges' partials summed in range order.
__global__ void __launch_bounds__(256)
mask_attn_bwd_dq_kernel(const float* __restrict__ dq_part,
                        __nv_bfloat16* __restrict__ dq, int nq, int heads,
                        int n_chunks) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int d_model = heads * HD;
  if (i >= (int64_t)nq * d_model) return;
  const int row = (int)(i / d_model), col = (int)(i % d_model);
  const int h = col / HD, c = col % HD;
  float s = 0.f;
  for (int k = 0; k < n_chunks; ++k)
    s += dq_part[(((int64_t)k * heads + h) * nq + row) * HD + c];
  dq[i] = __float2bfloat16(s);
}

int fwd_smem(int blocks_per_split) {
  return 1024 + TILE + FWD_STAGES * FWD_STAGE_BYTES + 4 * blocks_per_split;
}

int bwd_smem(int nq, int blocks_per_chunk) {
  const int n_qt = (nq + TQ - 1) / TQ, q_pad = n_qt * TQ;
  const int bits_bytes = ((q_pad * 8 + 1023) / 1024) * 1024;
  return 1024 + 2 * n_qt * TILE + 2 * (2 * TILE + bits_bytes) + 2 * TILE +
         4 * (n_qt * 16 * 128 + 2 * q_pad) +
         ((blocks_per_chunk + 15) / 16) * 16 + 4 * blocks_per_chunk;
}

}  // namespace

// p (nq, nk) float32 -> bits (nq, words) uint32, tiles (ceil(nq / 64),
// ceil(nk / 64)) uint8, row_closed (nq) uint8, stats (3) int64; scratch
// int32 of nq * (chunks + 1), chunks = ceil(words / 128).
extern "C" int tl_mask_attn_pack(const void* p, void* bits, void* tiles,
                                 void* row_closed, void* stats,
                                 void* scratch, int nq, int nk, int words,
                                 void* stream) {
  if (nq <= 0 || nk <= 0 || words < 4 * ((nk + 127) / 128) || words % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_qt = (nq + TQ - 1) / TQ, n_kb = (nk + TK - 1) / TK;
  const int n_chunks = (words + PACK_GROUPS * 32 - 1) / (PACK_GROUPS * 32);
  int* count_part = (int*)scratch;
  int* row_open = count_part + (int64_t)nq * n_chunks;
  mask_attn_pack_kernel<<<dim3(n_qt, n_chunks), 256, 0, s>>>(
      (const float*)p, (uint32_t*)bits, (uint8_t*)tiles, count_part, nq, nk,
      words);
  int err = (int)cudaGetLastError();
  if (err) return err;
  mask_attn_pack_fix_kernel<<<nq, 256, 0, s>>>(
      (uint32_t*)bits, (uint8_t*)tiles, count_part, row_open,
      (uint8_t*)row_closed, nk, words, n_chunks);
  err = (int)cudaGetLastError();
  if (err) return err;
  mask_attn_pack_stats_kernel<<<1, 1024, 0, s>>>(
      row_open, (const uint8_t*)tiles, (int64_t*)stats, nq,
      (int64_t)n_qt * n_kb);
  return (int)cudaGetLastError();
}

// q (nq, heads * 32) bf16, kv (nk, 2 * heads * 32) bf16 (keys, then
// values), bits / tiles of tl_mask_attn_pack; o_part (splits, heads, nq,
// 32) and ml_part (splits, heads, nq, 2) float32 scratch; out (nq, heads *
// 32) bf16, lse (heads, nq) float32 (log2 domain, scores times
// scale_log2).  splits = ceil(ceil(nk / 64) / blocks_per_split).
extern "C" int tl_mask_attn_fwd(const void* q, const void* kv,
                                const void* bits, const void* tiles,
                                void* o_part, void* ml_part, void* out,
                                void* lse, int nq, int nk, int words,
                                int heads, int blocks_per_split,
                                float scale_log2, void* stream) {
  if (nq <= 0 || nq > MAX_QT * TQ || nk <= 0 || heads <= 0 ||
      blocks_per_split <= 0 || blocks_per_split > 4096)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_kb = (nk + TK - 1) / TK;
  const int n_splits = (n_kb + blocks_per_split - 1) / blocks_per_split;
  const int smem = fwd_smem(blocks_per_split);
  cudaError_t e = cudaFuncSetAttribute(
      mask_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  mask_attn_fwd_kernel<<<dim3((nq + TQ - 1) / TQ, heads, n_splits), 128,
                         smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kv,
      (const uint32_t*)bits, (const uint8_t*)tiles, (float*)o_part,
      (float*)ml_part, nq, nk, words, heads, blocks_per_split, scale_log2);
  int err = (int)cudaGetLastError();
  if (err) return err;
  mask_attn_fwd_combine_kernel<<<(nq * heads + 3) / 4, 128, 0, s>>>(
      (const float*)o_part, (const float*)ml_part, (__nv_bfloat16*)out,
      (float*)lse, nq, heads, n_splits);
  return (int)cudaGetLastError();
}

// o, dout (nq, heads * 32) bf16, lse of tl_mask_attn_fwd; delta (heads,
// nq) and dq_part (chunks, heads, nq, 32) float32 scratch; dq (nq, heads *
// 32) bf16, dkv (nk, 2 * heads * 32) bf16 (every row written).
// chunks = ceil(ceil(nk / 64) / blocks_per_chunk).
extern "C" int tl_mask_attn_bwd(const void* q, const void* kv, const void* o,
                                const void* dout, const void* lse,
                                const void* bits, const void* tiles,
                                void* delta, void* dq_part, void* dq,
                                void* dkv, int nq, int nk, int words,
                                int heads, int blocks_per_chunk,
                                float scale_log2, float scale,
                                void* stream) {
  if (nq <= 0 || nq > MAX_QT * TQ || nk <= 0 || heads <= 0 ||
      blocks_per_chunk <= 0 || blocks_per_chunk > 4096)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_kb = (nk + TK - 1) / TK;
  const int n_chunks = (n_kb + blocks_per_chunk - 1) / blocks_per_chunk;
  mask_attn_bwd_delta_kernel<<<(nq * heads + 3) / 4, 128, 0, s>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (float*)delta, nq,
      heads);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int smem = bwd_smem(nq, blocks_per_chunk);
  cudaError_t e = cudaFuncSetAttribute(
      mask_attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  mask_attn_bwd_kernel<<<dim3(heads, n_chunks), 128, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kv,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta,
      (const uint32_t*)bits, (const uint8_t*)tiles, (__nv_bfloat16*)dkv,
      (float*)dq_part, nq, nk, words, heads, blocks_per_chunk, scale_log2,
      scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int64_t n = (int64_t)nq * heads * HD;
  mask_attn_bwd_dq_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)dq_part, (__nv_bfloat16*)dq, nq, heads, n_chunks);
  return (int)cudaGetLastError();
}

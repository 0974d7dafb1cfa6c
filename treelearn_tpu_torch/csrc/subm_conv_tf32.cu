// Submanifold sparse convolution in float32 on the tensor cores, 3xTF32.
//
// Replaces the Pallas kernel _subm_kernel + _gather_bands
// (treelearn_tpu/ops/pallas_conv.py:304,181, subm_conv_banded :355) for
// float32 features whose channel counts are multiples of 8 (the 4 -> 32
// input conv zero-padded to 8 input channels by the wrapper), at any
// offset count; it is also the conv's input gradient (the conv with the
// mirrored weights).  csrc/subm_conv.cu keeps what is left: bf16 at
// kernel sizes other than 3 and widths that are no multiple of 8.
//
//   out[i] = sum_k feats[rule[k, i]] @ W[k]      (rule -1: no input)
//   float32 in and out, float32 sums, rows i >= n_live are zeros
//
// Bound on the card: the products.  The tensor cores take float32 only as
// TF32 (10 mantissa bits, about three decimal digits), which the float32
// parity checks (rtol 1e-4 against the CPU) could not bear, so every
// product a b is taken as hi(a) hi(b) + hi(a) lo(b) + lo(a) hi(b), hi the
// TF32 rounding of a value and lo the TF32 rounding of what is left: float32
// accuracy at three TF32 products, 495 / 3 TFLOP/s of float32 work, against
// 67 TFLOP/s on the SIMT units.  At 32..224 channels the products still
// take microseconds; what a launch pays for is the gather of the rows
// (twice bf16's bytes) and the weight images (hi and lo: four times
// bf16's), and at the deepest levels the length of one block's K loop.
// The design follows subm_conv_wgmma.cu where TF32 allows it:
//
// * A block owns BM = 64 output voxels (one consumer warpgroup) and BN
//   output channels (ops/subm_conv.py:conv_plan_tf32 decides: the whole
//   Cout where it fits 128, 32-channel blocks on small levels).
//   Output-stationary, float32 sums in registers, no atomics: two launches
//   give the same bits.  The tensor cores add into their accumulator
//   rounding toward zero, which over the thousands of k8 steps of a deep
//   K loop biases a sum by ~1e-4 of its size (measured on the H100: the
//   float32 checks caught it); so each ring slot's products start afresh
//   and are added into a second set of float32 registers with
//   round-to-nearest FADDs.  Two register sets are why BN stops at 128.
// * K loop = (offsets that some row of the tile uses, the count a launch
//   argument: 27 at kernel_size 3, 125 at 5) x (Cin in slices of SK = 8, 16
//   or 32 channels, 1..4 k8 steps a slot).
// * A (gathered rows) comes in by 16-byte cp.async, zero-fill form for rule
//   -1, row-major in the 128/64/32-byte swizzle of SK channels a row, so
//   that the consumers' fragment loads are free of bank conflicts.  TF32
//   operands in shared memory must be K-major and the A fragment must be
//   split into hi and lo anyway, so A goes to the tensor cores from
//   registers: each consumer thread loads its four values a k8 step, splits
//   them (cvt.rna.tf32.f32) and issues the three products.
// * B (the weight slice) is two packed images, hi and lo, that the wrapper
//   prepared once per weight tensor (pack kernel below): for each k8 step
//   a K-major tile of BN rows x 8 TF32 values in the 32-byte swizzle.  The
//   copy engine brings a slot's images (cp.async.bulk, counted in bytes on
//   the slot's full mbarrier).
// * Warp specialisation as in subm_conv_wgmma.cu: 4 producer warps fill a
//   ring of `stages` slots, the consumer warpgroup multiplies; each slot has
//   a full and an empty mbarrier.  The consumer waits for a slot's products
//   before it hands the slot back (wgmma.wait_group 0), so registers of an
//   A fragment are never rewritten under a running wgmma; a second block
//   on the SM (the plans keep the shared memory small enough) covers that
//   wait.
// * Epilogue: float2 stores straight from the float32 totals.

#include <cuda_runtime.h>
#include <stdint.h>
#include "wgmma.cuh"

namespace {

constexpr int BM = 64;           // output voxels per block
constexpr int PRODUCERS = 128;   // producer threads
constexpr int NT = 128 + PRODUCERS;
constexpr int MAX_STAGES = 8;
constexpr int MAX_KSTEPS = 4;    // k8 steps of a slot (SK = 32)
constexpr int MAX_OFFSETS = 343; // kernel_size 7

// BN: output channels per block.  Dynamic shared memory, from a 1024-byte
// aligned base:
//   ring      stages x (A: BM x SK float32, B: hi and lo images 2 x BN x SK)
//   full[8], empty[8] mbarriers
//   rule_s    n_offsets x BM int32, -1 for no input and for rows past n_live
//   k_list    the present offsets, then their count; present[n_offsets]
template <int BN>
__global__ void __launch_bounds__(NT, 1)
subm_conv_tf32_kernel(const float* __restrict__ feats,
                      const float* __restrict__ wpack,
                      const int32_t* __restrict__ rule,
                      float* __restrict__ out, int v_out, int n_live,
                      int cin, int cout, int n_offsets, int sk, int stages) {
  const int ksteps = sk / 8;
  const int nch = sk / 4;                     // 16-byte chunks of an A row
  const int sw_shift = nch == 8 ? 0 : (nch == 4 ? 1 : 2);
  const int a_bytes = BM * sk * 4;
  const int b_bytes = 2 * BN * sk * 4;
  const int stage_bytes = a_bytes + b_bytes;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t ring_addr = smem_u32(ring);
  uint8_t* after_ring = ring + (size_t)stages * stage_bytes;
  const uint32_t full_bar = smem_u32(after_ring);       // + 8 * slot
  const uint32_t empty_bar = full_bar + 8 * MAX_STAGES;
  int32_t* rule_s = (int32_t*)(after_ring + 16 * MAX_STAGES);
  int* k_list = (int*)(rule_s + n_offsets * BM);   // offsets, then count
  int* present = k_list + n_offsets + 1;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int n_slices = cin / sk;

  for (int e = tid; e < n_offsets; e += NT) present[e] = 0;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // full: every producer thread's row copies and the images' bytes
      // (one more arrival announces those); empty: the consumer warpgroup
      mbar_init(full_bar + 8 * s, PRODUCERS + 1);
      mbar_init(empty_bar + 8 * s, 1);
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
  if (tid < 32) {   // compact the present offsets, in order
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

  if (tid >= 128) {
    // ---- producer warps: fill the ring, never touch the output
    const int p = tid - 128;
    int slot = 0, step = 0;
    uint32_t phase = 0;
    bool refill = false;   // the ring has gone round: wait for the consumer
    for (int ki = 0; ki < n_present; ++ki) {
      const int k = k_list[ki];
      const int32_t* idx = rule_s + k * BM;
      const float* image =
          wpack + ((int64_t)k * n_splits + split) * n_slices * (2 * BN * sk);
      for (int slice = 0; slice < n_slices; ++slice) {
        if (refill) mbar_wait(empty_bar + 8 * slot, phase ^ 1u);
        const uint32_t a_addr = ring_addr + slot * stage_bytes;
        const uint32_t bar = full_bar + 8 * slot;
        // the warps take turns at starting the images' bulk copy
        if (p == 32 * (step++ % (PRODUCERS / 32))) {
          mbar_expect_tx(bar, b_bytes);
          bulk_copy(a_addr + a_bytes, image + slice * (2 * BN * sk), b_bytes,
                    bar);
        }
        const float* col = feats + slice * sk;
        for (int q = p; q < BM * nch; q += PRODUCERS) {
          const int r = q / nch;
          const int c = q - r * nch;
          const int src = idx[r];
          const float* g = col + (int64_t)(src < 0 ? 0 : src) * cin + c * 4;
          cp_async16(a_addr + r * sk * 4 +
                         ((c ^ ((r >> sw_shift) & (nch - 1))) << 4),
                     g, src < 0 ? 0u : 16u);
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

  // ---- consumer warpgroup
  const int lane = tid & 31;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = 16 * (tid >> 5) + g8;   // this thread's rows r0, r0 + 8
  const int n_steps = n_present * n_slices;
  float acc[BN / 2], total[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = total[i] = 0.f;

  int slot = 0;
  uint32_t phase = 0;
  for (int s = 0; s < n_steps; ++s) {
    mbar_wait(full_bar + 8 * slot, phase);
    const float* a_tile = (const float*)(ring + slot * stage_bytes);
    uint32_t ah[MAX_KSTEPS][4], al[MAX_KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < MAX_KSTEPS; ++kk) {
      if (kk < ksteps) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + 8 * (i & 1);
          const int c = 2 * kk + (i >> 1);   // chunk of column 8 kk + t (+ 4)
          const float x =
              a_tile[r * sk + ((c ^ ((r >> sw_shift) & (nch - 1))) << 2) + t4];
          tf32_split(x, ah[kk][i], al[kk][i]);
        }
      }
    }
    const uint32_t b_addr = ring_addr + slot * stage_bytes + a_bytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MAX_KSTEPS; ++kk) {
      if (kk < ksteps) {
        const uint64_t bh = tf32_desc(b_addr + kk * (BN * 32));
        const uint64_t bl = tf32_desc(b_addr + BN * sk * 4 + kk * (BN * 32));
        mma_tf32x3<BN>(acc, ah[kk], al[kk], bh, bl, kk == 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    tf32_flush<BN>(total, acc);
#pragma unroll
    for (int kk = 0; kk < MAX_KSTEPS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        reg_fence(ah[kk][i]);
        reg_fence(al[kk][i]);
      }
    // the slot's products are done: hand it back
    if (tid == 0) mbar_arrive(empty_bar + 8 * slot);
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + r0 + 8 * half;
    if (row >= v_out) continue;
    const bool live = row < n_live;
    float* dst = out + (int64_t)row * cout + split * BN + 2 * t4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *(float2*)(dst + 8 * j) =
          live ? make_float2(total[4 * j + 2 * half],
                             total[4 * j + 2 * half + 1])
               : make_float2(0.f, 0.f);
  }
}

// The B images the conv kernel copies: for offset k, column split j, K
// slice s (SK channels) and image h (0: hi, 1: lo) SK / 8 tiles, one per k8
// step, of bn rows (output channels) x 8 TF32 values, K-major in the 32-byte
// swizzle.  One thread per 16-byte chunk.  `w` is (K, cin, cout); with
// `mirror` it is (K, cout, cin) and the tile is that of
// W.flip(0).transpose(1, 2), the weights of the conv's input gradient.
__global__ void pack_weight_tf32_kernel(const float* __restrict__ w,
                                        float* __restrict__ wpack, int cin,
                                        int cout, int bn, int sk,
                                        int n_offsets, int mirror) {
  const int64_t chunk = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (chunk >= (int64_t)n_offsets * cout * cin / 2) return;
  const int ksteps = sk / 8;
  const int n_slices = cin / sk;
  const int pos = (int)(chunk & 1);
  int64_t rest = chunk >> 1;
  const int n = (int)(rest % bn);
  rest /= bn;
  const int kk = (int)(rest % ksteps);
  rest /= ksteps;
  const int img = (int)(rest & 1);
  rest >>= 1;
  const int slice = (int)(rest % n_slices);
  rest /= n_slices;
  const int split = (int)(rest % (cout / bn));
  const int k = (int)(rest / (cout / bn));
  const int c = pos ^ ((n >> 2) & 1);
  const int col = split * bn + n;                  // output channel
  const int ch = slice * sk + kk * 8 + c * 4;      // first of 4 input channels
  float v[4];
  if (mirror) {
    const float* src =
        w + ((int64_t)(n_offsets - 1 - k) * cout + col) * cin + ch;
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = src[e];
  } else {
    const float* src = w + ((int64_t)k * cin + ch) * cout + col;
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = src[(int64_t)e * cout];
  }
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) tf32_split(v[e], hi[e], lo[e]);
  const uint32_t* u = img ? lo : hi;
  *(uint4*)&wpack[chunk * 4] = make_uint4(u[0], u[1], u[2], u[3]);
}

template <int BN>
int launch(const void* feats, const void* wpack, const void* rule, void* out,
           int v_out, int n_live, int cin, int cout, int n_offsets, int sk,
           int stages, int smem_bytes, cudaStream_t stream) {
  auto kernel = subm_conv_tf32_kernel<BN>;
  // above 48 KB a kernel must be granted its dynamic shared memory; the
  // grant is per device, so it is renewed at every launch
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((v_out + BM - 1) / BM, cout / BN);
  kernel<<<grid, NT, smem_bytes, stream>>>(
      (const float*)feats, (const float*)wpack, (const int32_t*)rule,
      (float*)out, v_out, n_live, cin, cout, n_offsets, sk, stages);
  return (int)cudaGetLastError();
}

bool valid_sk(int sk) { return sk == 8 || sk == 16 || sk == 32; }

}  // namespace

// w: (n_offsets, cin, cout) float32, or with `mirror` (n_offsets, cout,
// cin); wpack: 2 * n_offsets * cin * cout float32, laid out as
// ops/subm_conv.py:pack_weight_tf32 says.
extern "C" int tl_pack_weight_tf32(const void* w, void* wpack, int cin,
                                   int cout, int bn, int sk, int n_offsets,
                                   int mirror, void* stream) {
  if (!valid_sk(sk) || cin % sk != 0 || bn <= 0 || bn % 8 != 0 ||
      cout % bn != 0 || n_offsets < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t chunks = (int64_t)n_offsets * cout * cin / 2;
  pack_weight_tf32_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0,
                            (cudaStream_t)stream>>>(
      (const float*)w, (float*)wpack, cin, cout, bn, sk, n_offsets, mirror);
  return (int)cudaGetLastError();
}

// feats (V_in, cin) float32; wpack: the images of tl_pack_weight_tf32;
// rule (n_offsets, v_out) int32; out (v_out, cout) float32.  bn, sk,
// stages, smem_bytes: the plan of ops/subm_conv.py:conv_plan.
extern "C" int tl_subm_conv_tf32(const void* feats, const void* wpack,
                                 const void* rule, void* out, int v_out,
                                 int n_live, int cin, int cout, int n_offsets,
                                 int bn, int sk, int stages, int smem_bytes,
                                 void* stream) {
  if (!valid_sk(sk) || cin % sk != 0 || bn <= 0 || cout % bn != 0 ||
      stages < 2 || stages > MAX_STAGES || n_offsets < 1 ||
      n_offsets > MAX_OFFSETS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define TL_CASE(BN)                                                         \
  if (bn == BN)                                                             \
    return launch<BN>(feats, wpack, rule, out, v_out, n_live, cin, cout,    \
                      n_offsets, sk, stages, smem_bytes, s);
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

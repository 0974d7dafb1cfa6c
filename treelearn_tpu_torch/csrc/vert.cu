// Neighborhood moments for verticality.
//
// Replaces the Pallas kernel _vert_kernel (treelearn_tpu/ops/pallas_vert.py:68).
// The TPU kernel DMAs three banded windows of the xy-cell-sorted refs per
// tile of 64 queries and masks a dense (tile, window) block, with a
// window-overflow fallback.  Here:
//
//   refs are sorted by 3-D cell key with z fastest and packed as 16-byte
//   records (x, y, z, 0); ranges[g] holds, for query group g (the queries of
//   one cell, sorted by the same key), the 9 contiguous sorted-ref ranges
//   [lo, hi) of its (dx, dy) neighbors, cells iz - 1 .. iz + 1 each
//   (ops/vert.py:prepare; with the xy table each range is one xy column).
//   For every query the kernel sums, over every ref of those ranges within
//   the radius, the 10 moments of d = ref - query in float32:
//   count, dx, dy, dz, dx dx, dx dy, dx dz, dy dy, dy dz, dz dz.
//
// Coordinates are centred on the query so the second moments stay far from
// the E[x^2] - E[x]^2 cancellation; never bf16.  The in-radius test
// d2 = (dx*dx + dy*dy) + dz*dz <= r2 is rounded step by step (__fmul_rn /
// __fadd_rn, no FMA contraction) so that it decides exactly as the plain
// PyTorch version (ops/vert.py:moments_plain) does for refs on the radius:
// the counts are equal, the sums differ by their order only.  The eigen step
// runs in PyTorch afterwards.  No window, so nothing overflows.
//
// Bound on the card: the float32 rate (about 30 operations per in-radius
// pair) on dense clouds, memory on sparse ones.  The first version, one
// thread a query over an xy table, lost it three ways: it tested the whole
// vertical column of its 3 x 3 cells, 15-25 m of stem and crown against a
// ball of 1.2 m; every thread read its ranges itself from global memory,
// 4 bytes at a stride of 12, so the 32 lanes of a warp issued 32 addresses
// a load; and a warp lasted as long as its longest walker.  The design:
//
// * The 3-D table cuts the candidates to the 27 cells around the query.
// * A warp serves one work item of ops/vert.py:group_items: `qs` queries of
//   one group (a power of two <= 32) x P = 32 / qs candidate partitions.
//   Lane l has query l % qs and partition l / qs.  The unit is a warp, not a
//   block, because most groups of a forest plot hold a handful of queries:
//   a warp needs no block-wide barrier, and eight items share a block.  The
//   items come longest walk first, so the eight are about equally long.
// * The group's 9 ranges are walked as one sequence of candidate positions,
//   staged through two shared-memory tiles of 64 records a warp by 16-byte
//   cp.async (a record is one aligned copy), tile t + 1 in flight while
//   tile t is scanned.  Partition p scans positions p, p + P, ...; lanes of
//   one partition read the same record (a broadcast, no bank conflict).
// * Moments stay in registers.  The P partial sums of a query are added by
//   an xor-shuffle tree over the partition bits of the lane index: a fixed
//   order, so repeat launches are bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;     // items a block serves
constexpr int TILE = 64;     // records per staged tile
constexpr int RANGES = 9;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(WARPS * 32)
vert_group_kernel(const float4* __restrict__ refs4, const float* __restrict__ q,
                  const int32_t* __restrict__ ranges,
                  const int4* __restrict__ items, int n_items, float r2,
                  float* __restrict__ mom) {
  __shared__ float4 tiles[WARPS][2][TILE];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * WARPS + warp;
  if (item >= n_items) return;   // the whole warp: no block-wide barrier below
  const int4 it = items[item];   // first query, queries, qs, group
  const int qs = it.z;           // power of two, <= 32
  const int parts = 32 / qs;
  const int ql = lane & (qs - 1);
  const int part = lane >> (__ffs(qs) - 1);
  const bool has_q = ql < it.y;
  const int qi = it.x + (has_q ? ql : 0);
  const float qx = q[3 * (int64_t)qi], qy = q[3 * (int64_t)qi + 1],
              qz = q[3 * (int64_t)qi + 2];
  // the 9 ranges laid end to end: range r holds positions c[r] .. c[r + 1),
  // position pos of it is sorted ref pos + off[r]
  const int32_t* rg = ranges + 2 * RANGES * (int64_t)it.w;
  int c[RANGES + 1], off[RANGES];
  c[0] = 0;
#pragma unroll
  for (int r = 0; r < RANGES; ++r) {
    const int s = rg[2 * r], e = rg[2 * r + 1];
    off[r] = s - c[r];
    c[r + 1] = c[r] + (e - s);
  }
  const int total = c[RANGES];
  const int n_tiles = (total + TILE - 1) / TILE;
  float4(*tile2)[TILE] = tiles[warp];

  auto stage = [&](int t) {
    float4* dst = tile2[t & 1];
#pragma unroll
    for (int u = 0; u < TILE / 32; ++u) {
      const int i = lane + 32 * u;
      const int pos = t * TILE + i;
      if (pos < total) {
        int o = off[0];
#pragma unroll
        for (int r = 1; r < RANGES; ++r)
          if (pos >= c[r]) o = off[r];
        cp_async16(dst + i, refs4 + (pos + o));
      }
    }
    cp_async_commit();
  };

  float m[10];
#pragma unroll
  for (int t = 0; t < 10; ++t) m[t] = 0.f;
  const float lim = has_q ? r2 : -1.f;   // a lane without a query sums nothing

  if (n_tiles > 0) stage(0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();   // tile t has landed for every lane
    const float4* tile = tile2[t & 1];
    const int n_in = min(TILE, total - t * TILE);
#pragma unroll 4
    for (int j = part; j < n_in; j += parts) {
      const float4 r = tile[j];
      const float dx = __fsub_rn(r.x, qx);
      const float dy = __fsub_rn(r.y, qy);
      const float dz = __fsub_rn(r.z, qz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 <= lim) {
        m[0] += 1.f;
        m[1] += dx;
        m[2] += dy;
        m[3] += dz;
        m[4] += dx * dx;
        m[5] += dx * dy;
        m[6] += dx * dz;
        m[7] += dy * dy;
        m[8] += dy * dz;
        m[9] += dz * dz;
      }
    }
    __syncwarp();   // tile t may be refilled
  }

  // add the partitions' sums: lanes ql, ql + qs, ql + 2 qs, ... pairwise
  for (int d = 16; d >= qs; d >>= 1) {
#pragma unroll
    for (int t = 0; t < 10; ++t)
      m[t] += __shfl_xor_sync(0xffffffffu, m[t], d);
  }
  if (part == 0 && has_q) {
    float2* dst = (float2*)(mom + 10 * (int64_t)qi);   // 40-byte rows
#pragma unroll
    for (int t = 0; t < 5; ++t) dst[t] = make_float2(m[2 * t], m[2 * t + 1]);
  }
}

}  // namespace

// refs4 (R, 4) float32 records, q (Q, 3) float32, ranges (G, 18) int32,
// items (n_items, 4) int32 rows (first query, queries, queries per warp: a
// power of two <= 32, group) that partition the queries into slices of
// single groups; mom (Q, 10) float32.
extern "C" int tl_vert_moments(const void* refs4, const void* q,
                               const void* ranges, const void* items,
                               int n_items, float r2, void* mom,
                               void* stream) {
  const int blocks = (n_items + WARPS - 1) / WARPS;
  vert_group_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float4*)refs4, (const float*)q, (const int32_t*)ranges,
      (const int4*)items, n_items, r2, (float*)mom);
  return (int)cudaGetLastError();
}

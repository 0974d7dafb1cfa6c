// Banded k-NN majority vote: one pass of the cell-escalation search.
//
// Replaces the Pallas kernel _knn_kernel / _knn_pallas_call
// (treelearn_tpu/ops/pallas_knn.py:48,125) together with the XLA top-k merge
// and vote that follow it in the same jit (:188-213).  The TPU kernel DMAs
// three 128-aligned ref windows per tile of 64 queries, extracts a per-band
// top-k by repeated masked minima and flags tiles whose windows overflow; a
// GPU block can walk its own neighbor cells, so here:
//
//   refs are sorted by xy cell key (cell = the pass radius, coordinates
//   already scaled by f32(1/cell), so the radius is 1) and packed as 16-byte
//   records (x, y, z, label bits); ranges[q] holds the three contiguous
//   sorted-ref ranges [lo, hi) of cell rows i-1, i, i+1, columns j-1 .. j+1
//   around query q.  Queries are sorted by the same key, so all queries of
//   one cell (a group) have the same ranges.
//
//   winner[q] = the vote over the k nearest in-radius refs when n_found[q]
//               == k (the most frequent label, the smallest among equally
//               frequent ones: np.bincount-argmax parity), else -1
//   n_found[q] = min(#refs within radius 1, k)
//
// A query is done exactly when it found k refs within the radius: then its
// k nearest refs all lie in the 3 x 3 cells it walked.  No windows, so
// nothing overflows.  d2 = (dx*dx + dy*dy) + dz*dz is rounded step by step
// (__fmul_rn / __fadd_rn, no FMA contraction) so that the kernel and the
// plain PyTorch version (ops/knn.py:knn_pass_plain) decide identically on
// the radius and on the order.
//
// Bound on the card: the float32 instruction rate (about 10 operations per
// candidate ref and query) on clumped refs and in the late rounds, where a
// few cells hold 10^4..10^5 candidates each; memory on sparse ones.  The
// first version, one thread a query, lost it to dependent scalar loads from
// global memory and to warps that lasted as long as their longest candidate
// list.  The design:
//
// * A block of 256 threads serves one work item of ops/knn.py:pass_items:
//   `qs` queries of one group (a power of two) x P = 256 / qs candidate
//   partitions.  Thread t has query t % qs and partition t / qs.  Groups
//   with few candidates take P = 1 (one thread a query, as before, but all
//   reading the same staged ref); groups with many split them P ways, so a
//   late round's handful of long lists spreads over the whole card, while a
//   group with many queries keeps at least 32 of them a block so that a
//   staged ref is used 32 times.
// * The group's three ranges are walked as one sequence of candidate
//   positions, staged through two shared-memory tiles of 1024 records by
//   16-byte cp.async (a record is one aligned copy), tile t + 1 in flight
//   while tile t is scanned.  Partition p scans positions p, p + P, ...;
//   threads of one partition read the same record (a broadcast).
// * Each thread keeps its k nearest as (d2, position) in registers.  Once k
//   are held the test is d2 < k-th d2 instead of d2 <= 1, and dx*dx + dy*dy
//   alone is tested before z is touched; neither changes the result, since
//   rounding is monotone (d2 >= dx*dx + dy*dy as floats).
// * Positions increase along the sorted refs, so "nearer first, equal
//   distances in sorted-ref order" is the total order (d2, position).  Every
//   insertion compares that pair, and the P partial lists of a query are
//   merged pairwise through shared memory by the same order, which makes the
//   split exact.  n_found is the sum of the partial counts, clamped to k.
//   Labels are read from the records of the k winners at the end, as bits
//   (__float_as_int), never converted.
//
// Block and tile size and the split rule (CANDS_PER_PART, MIN_SLICE in
// ops/knn.py) were settled on the H100 with tools/knn_tune.py on the bench
// plot's own problem: 256 threads x 1024 records took 2.01 ms a call, 256 x
// 512 2.13, 128 x 512 2.16, 128 x 256 2.26, 512 x 1024 2.08 (see PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K_MAX = 8;
constexpr int THREADS = 256;
constexpr int TILE = 1024;   // records per staged tile

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

// keep the K smallest of the list and (cd, cv) by (d2, position)
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bv)[K], float cd,
                                       int cv) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    if (cd < bd[t] || (cd == bd[t] && cv < bv[t])) {
      const float td = bd[t];
      const int tv = bv[t];
      bd[t] = cd;
      bv[t] = cv;
      cd = td;
      cv = tv;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
knn_group_kernel(const float4* __restrict__ refs4, const float* __restrict__ q,
                 const int32_t* __restrict__ ranges,
                 const int32_t* __restrict__ items,
                 int32_t* __restrict__ winner, int32_t* __restrict__ n_found) {
  // two staged tiles during the walk, the partial lists during the merge
  __shared__ float4 tiles[2 * TILE];
  __shared__ int cnt_s[THREADS];
  static_assert(2 * TILE * 16 >= THREADS * K_MAX * 8, "lists fit the tiles");
  float* list_d = (float*)tiles;              // [K][THREADS]
  int* list_v = (int*)tiles + K_MAX * THREADS;

  const int tid = threadIdx.x;
  const int q0 = items[3 * blockIdx.x];
  const int nq = items[3 * blockIdx.x + 1];
  const int qs = items[3 * blockIdx.x + 2];   // power of two, <= THREADS
  const int parts = THREADS / qs;
  const int ql = tid & (qs - 1);
  const int part = tid >> (__ffs(qs) - 1);
  const bool has_q = ql < nq;
  const int qi = q0 + (has_q ? ql : 0);
  const float qx = q[3 * (int64_t)qi], qy = q[3 * (int64_t)qi + 1],
              qz = q[3 * (int64_t)qi + 2];
  // the group's ranges: every query of the item has this row
  const int32_t* rg = ranges + 6 * (int64_t)q0;
  const int s0 = rg[0], s1 = rg[2], s2 = rg[4];
  const int c1 = rg[1] - s0;
  const int c2 = c1 + rg[3] - s1;
  const int total = c2 + rg[5] - s2;
  const int n_tiles = (total + TILE - 1) / TILE;

  const float one_plus = __int_as_float(0x3f800001);   // d2 <= 1 as d2 < this
  float bd[K];
  int bv[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = __int_as_float(0x7f800000);   // +inf
    bv[t] = 0x7fffffff;
  }
  int cnt = 0;
  float lim = has_q ? one_plus : -1.f;   // a thread without a query keeps none

  auto stage = [&](int t) {
    float4* dst = tiles + (t & 1) * TILE;
    for (int i = tid; i < TILE; i += THREADS) {
      const int pos = t * TILE + i;
      if (pos < total) {
        const int ref = pos < c1 ? s0 + pos
                                 : (pos < c2 ? s1 + (pos - c1) : s2 + (pos - c2));
        cp_async16(dst + i, refs4 + ref);
      }
    }
    cp_async_commit();
  };

  if (n_tiles > 0) stage(0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile t has landed for every thread
    const float4* tile = tiles + (t & 1) * TILE;
    const int base = t * TILE;
    const int n_in = min(TILE, total - base);
#pragma unroll 4
    for (int j = part; j < n_in; j += parts) {
      const float4 r = tile[j];
      const float dx = __fsub_rn(r.x, qx);
      const float dy = __fsub_rn(r.y, qy);
      const float dxy = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      if (dxy < lim) {
        const float dz = __fsub_rn(r.z, qz);
        const float cd = __fadd_rn(dxy, __fmul_rn(dz, dz));
        if (cd < lim) {
          ++cnt;
          insert<K>(bd, bv, cd, base + j);
          lim = fminf(bd[K - 1], one_plus);
        }
      }
    }
    __syncthreads();   // tile t may be refilled (and the lists may move in)
  }

  // merge the partitions' lists pairwise: partition p takes in p + h
  cnt = min(cnt, K);
  for (int h = parts >> 1; h >= 1; h >>= 1) {
    if (part >= h && part < 2 * h) {
#pragma unroll
      for (int t = 0; t < K; ++t) {
        list_d[t * THREADS + tid] = bd[t];
        list_v[t * THREADS + tid] = bv[t];
      }
      cnt_s[tid] = cnt;
    }
    __syncthreads();
    if (part < h) {
      const int other = tid + h * qs;
      cnt = min(cnt + cnt_s[other], K);
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const float cd = list_d[t * THREADS + other];
        if (cd <= 1.f) insert<K>(bd, bv, cd, list_v[t * THREADS + other]);
      }
    }
  }

  if (part != 0 || !has_q) return;
  int best = -1;
  if (cnt == K) {
    int bl[K];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const int pos = bv[t];
      const int ref = pos < c1 ? s0 + pos
                               : (pos < c2 ? s1 + (pos - c1) : s2 + (pos - c2));
      bl[t] = __float_as_int(refs4[ref].w);
    }
    int best_count = 0;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      int c = 0;
#pragma unroll
      for (int b = 0; b < K; ++b)
        if (bl[b] == bl[a]) ++c;
      if (c > best_count || (c == best_count && bl[a] < best)) {
        best_count = c;
        best = bl[a];
      }
    }
  }
  winner[qi] = best;
  n_found[qi] = cnt;
}

template <int K>
int launch_group(const void* refs4, const void* q, const void* ranges,
                 const void* items, int n_items, void* winner, void* n_found,
                 cudaStream_t stream) {
  knn_group_kernel<K><<<n_items, THREADS, 0, stream>>>(
      (const float4*)refs4, (const float*)q, (const int32_t*)ranges,
      (const int32_t*)items, (int32_t*)winner, (int32_t*)n_found);
  return (int)cudaGetLastError();
}

}  // namespace

// refs4 (R, 4) float32 records (x, y, z, label bits), q (Q, 3) float32,
// ranges (Q, 6) int32, items (n_items, 3) int32 rows (first query, queries,
// queries per block: a power of two <= 256) that partition the queries into
// slices of single groups; winner, n_found (Q,) int32.
extern "C" int tl_knn_vote(const void* refs4, const void* q,
                           const void* ranges, const void* items, int n_items,
                           int k, void* winner, void* n_found, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
#define TL_CASE(K)                                                          \
  case K:                                                                   \
    return launch_group<K>(refs4, q, ranges, items, n_items, winner,        \
                           n_found, s);
    TL_CASE(1) TL_CASE(2) TL_CASE(3) TL_CASE(4)
    TL_CASE(5) TL_CASE(6) TL_CASE(7) TL_CASE(8)
#undef TL_CASE
  }
  return (int)cudaErrorInvalidValue;
}

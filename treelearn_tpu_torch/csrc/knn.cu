// Banded k-NN majority vote: one pass of the cell-escalation search.
//
// Replaces the Pallas kernel _knn_kernel / _knn_pallas_call
// (treelearn_tpu/ops/pallas_knn.py:48,125) together with the XLA top-k merge
// and vote that follow it in the same jit (:188-213).  The TPU kernel DMAs
// three 128-aligned ref windows per tile of 64 queries, extracts a per-band
// top-k by repeated masked minima and flags tiles whose windows overflow; a
// GPU thread can walk its own neighbor cells, so here:
//
//   refs are sorted by xy cell key (cell = the pass radius, coordinates
//   already scaled by f32(1/cell), so the radius is 1); ranges[q] holds the
//   three contiguous sorted-ref ranges [lo, hi) of cell rows i-1, i, i+1,
//   columns j-1 .. j+1 around query q.  One thread per query walks them in
//   order, keeps the K_MAX nearest in-radius refs (d2, label) in registers by
//   insertion (a ref replaces a kept one only when strictly nearer, so equal
//   distances keep visiting order = sorted-ref order), then votes over the
//   first k: the most frequent label, the smallest among equally frequent
//   ones (np.bincount-argmax parity).
//
//   winner[q] = the vote when n_found[q] == k, else -1
//   n_found[q] = min(#refs within radius 1, k)
//
// A query is done exactly when it found k refs within the radius: then its
// k nearest refs all lie in the 3 x 3 cells it walked.  No windows, so
// nothing overflows.  d2 = (dx*dx + dy*dy) + dz*dz is rounded step by step
// (__fmul_rn / __fadd_rn, no FMA contraction) so that the kernel and the
// plain PyTorch version (ops/knn.py:knn_pass_plain) decide identically on
// the radius and on the order.
//
// Bound: the float32 rate for clumped refs (about 10 operations per
// candidate ref), memory for sparse ones; neighboring queries walk the same
// refs (queries are sorted by cell too), so the candidate reads hit L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K_MAX = 8;

__global__ void knn_kernel(const float* __restrict__ refs,
                           const int32_t* __restrict__ labels,
                           const float* __restrict__ q,
                           const int32_t* __restrict__ ranges, int nq, int k,
                           int32_t* __restrict__ winner,
                           int32_t* __restrict__ n_found) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const float qx = q[3 * (int64_t)i], qy = q[3 * (int64_t)i + 1],
              qz = q[3 * (int64_t)i + 2];
  float bd[K_MAX];
  int bl[K_MAX];
#pragma unroll
  for (int t = 0; t < K_MAX; ++t) {
    bd[t] = __int_as_float(0x7f800000);  // +inf
    bl[t] = -1;
  }
  int cnt = 0;
  for (int band = 0; band < 3; ++band) {
    const int s = ranges[6 * (int64_t)i + 2 * band];
    const int e = ranges[6 * (int64_t)i + 2 * band + 1];
    for (int r = s; r < e; ++r) {
      const float dx = __fsub_rn(refs[3 * (int64_t)r], qx);
      const float dy = __fsub_rn(refs[3 * (int64_t)r + 1], qy);
      const float dz = __fsub_rn(refs[3 * (int64_t)r + 2], qz);
      float cd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                           __fmul_rn(dz, dz));
      if (!(cd <= 1.f)) continue;
      ++cnt;
      int cl = labels[r];
#pragma unroll
      for (int t = 0; t < K_MAX; ++t) {
        if (cd < bd[t]) {
          const float td = bd[t];
          const int tl = bl[t];
          bd[t] = cd;
          bl[t] = cl;
          cd = td;
          cl = tl;
        }
      }
    }
  }
  const int found = cnt < k ? cnt : k;
  int best = -1;
  if (found == k) {
    int best_count = 0;
#pragma unroll
    for (int a = 0; a < K_MAX; ++a) {
      if (a >= k) break;
      int c = 0;
#pragma unroll
      for (int b = 0; b < K_MAX; ++b)
        if (b < k && bl[b] == bl[a]) ++c;
      if (c > best_count || (c == best_count && bl[a] < best)) {
        best_count = c;
        best = bl[a];
      }
    }
  }
  winner[i] = best;
  n_found[i] = found;
}

}  // namespace

extern "C" int tl_knn_vote(const void* refs, const void* labels, const void* q,
                           const void* ranges, int nq, int k, void* winner,
                           void* n_found, void* stream) {
  if (k < 1 || k > K_MAX) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (nq + threads - 1) / threads;
  knn_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)refs, (const int32_t*)labels, (const float*)q,
      (const int32_t*)ranges, nq, k, (int32_t*)winner, (int32_t*)n_found);
  return (int)cudaGetLastError();
}

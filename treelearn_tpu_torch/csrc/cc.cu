// Eps-graph found bits for DBSCAN-mode grouping.
//
// Replaces the Pallas kernel _cc_kernel (treelearn_tpu/ops/pallas_cc.py:51).
// With xy cells of eps / sqrt(2) every cell is a clique, and an eps-ball
// reaches at most two cells per axis, so a point's edges are summarised by
// 25 bits: bit (di + 2) * 5 + (dj + 2) is set when cell (i + di, j + dj)
// holds a point within eps.  The TPU kernel masks five banded windows per
// tile of 64 points, with a window-overflow fallback; here one thread per
// point looks each of the 25 neighbor cells up in the sorted unique cell
// keys (key = i * width + j) and walks that cell's points until one lies
// within eps.  The union-find over cell representatives runs on the host
// (ops/cc.py), as at pallas_cc.py:280-319.
//
// The distance test d2 = dx*dx + dy*dy <= eps2 is rounded step by step
// (__fmul_rn / __fadd_rn, no FMA contraction), as the plain PyTorch
// version computes it, so points on the eps circle decide identically.
//
// Bound: memory (8 B of coordinates and 8 B of cell index read, 4 B written
// per point); the cell walks of neighboring points hit the same cells in L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void cc_kernel(const float* __restrict__ pts,
                          const int32_t* __restrict__ cell_ij,
                          const int32_t* __restrict__ cell_keys,
                          const int32_t* __restrict__ cell_start, int n,
                          int n_cells, int width, float eps2,
                          int32_t* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float x = pts[2 * p], y = pts[2 * p + 1];
  const int pi = cell_ij[2 * p], pj = cell_ij[2 * p + 1];
  int32_t mask = 0;
  for (int di = -2; di <= 2; ++di) {
    const int ci = pi + di;
    if (ci < 0) continue;
    for (int dj = -2; dj <= 2; ++dj) {
      const int cj = pj + dj;
      if (cj < 0 || cj >= width) continue;
      const int64_t key = (int64_t)ci * width + cj;
      int lo = 0, hi = n_cells;
      while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if ((int64_t)cell_keys[mid] < key) lo = mid + 1; else hi = mid;
      }
      if (lo >= n_cells || (int64_t)cell_keys[lo] != key) continue;
      const int s = cell_start[lo], e = cell_start[lo + 1];
      for (int r = s; r < e; ++r) {
        const float dx = __fsub_rn(pts[2 * (int64_t)r], x);
        const float dy = __fsub_rn(pts[2 * (int64_t)r + 1], y);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        if (d2 <= eps2) {
          mask |= 1 << ((di + 2) * 5 + (dj + 2));
          break;
        }
      }
    }
  }
  out[p] = mask;
}

}  // namespace

extern "C" int tl_cc_found_bits(const void* pts, const void* cell_ij,
                                const void* cell_keys, const void* cell_start,
                                int n, int n_cells, int width, float eps2,
                                void* out, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  cc_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const int32_t*)cell_ij, (const int32_t*)cell_keys,
      (const int32_t*)cell_start, n, n_cells, width, eps2, (int32_t*)out);
  return (int)cudaGetLastError();
}

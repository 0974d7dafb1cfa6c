// Neighborhood moments for verticality.
//
// Replaces the Pallas kernel _vert_kernel (treelearn_tpu/ops/pallas_vert.py:68).
// The TPU kernel DMAs three banded windows of the cell-sorted refs per tile
// of 64 queries and masks a dense (tile, window) block, with a window-overflow
// fallback; a GPU thread can walk its own neighbor cells, so here:
//
//   refs are sorted by xy cell (cell = radius), cell_start[c] .. cell_start[c+1]
//   is cell c = i * nj + j; one thread per query visits the 3 x 3 cells around
//   its own (three contiguous ref ranges, one per cell row) and sums, over every
//   ref within the radius, the 10 moments of d = ref - query in float32:
//   count, dx, dy, dz, dx dx, dx dy, dx dz, dy dy, dy dz, dz dz.
//
// Coordinates are centred on the query so the second moments stay far from
// the E[x^2] - E[x]^2 cancellation; never bf16.  The in-radius test
// d2 = (dx*dx + dy*dy) + dz*dz <= r2 is rounded step by step (__fmul_rn /
// __fadd_rn, no FMA contraction) so that it decides exactly as the plain
// PyTorch version (ops/vert.py) does for refs on the radius.  The eigen step
// runs in PyTorch afterwards.  No window, so nothing overflows.
//
// Bound: memory for sparse clouds, the float32 rate for dense ones (about 30
// operations per candidate ref); refs of neighboring queries are shared
// through L1/L2 because queries are sorted by cell too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void vert_kernel(const float* __restrict__ refs,
                            const float* __restrict__ q,
                            const int32_t* __restrict__ q_cell,
                            const int32_t* __restrict__ cell_start, int nq,
                            int ni, int nj, float r2,
                            float* __restrict__ mom) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
  const int qi = q_cell[2 * i], qj = q_cell[2 * i + 1];
  float m[10];
#pragma unroll
  for (int t = 0; t < 10; ++t) m[t] = 0.f;
  const int jlo = qj > 0 ? qj - 1 : 0;
  const int jhi = qj + 1 < nj ? qj + 1 : nj - 1;
  for (int di = -1; di <= 1; ++di) {
    const int ci = qi + di;
    if (ci < 0 || ci >= ni) continue;
    const int64_t base = (int64_t)ci * nj;
    const int s = cell_start[base + jlo];
    const int e = cell_start[base + jhi + 1];
    for (int r = s; r < e; ++r) {
      const float dx = __fsub_rn(refs[3 * (int64_t)r], qx);
      const float dy = __fsub_rn(refs[3 * (int64_t)r + 1], qy);
      const float dz = __fsub_rn(refs[3 * (int64_t)r + 2], qz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 <= r2) {
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
  }
#pragma unroll
  for (int t = 0; t < 10; ++t) mom[10 * (int64_t)i + t] = m[t];
}

}  // namespace

extern "C" int tl_vert_moments(const void* refs, const void* q,
                               const void* q_cell, const void* cell_start,
                               int nq, int ni, int nj, float r2, void* mom,
                               void* stream) {
  const int threads = 128;
  const int blocks = (nq + threads - 1) / threads;
  vert_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)refs, (const float*)q, (const int32_t*)q_cell,
      (const int32_t*)cell_start, nq, ni, nj, r2, (float*)mom);
  return (int)cudaGetLastError();
}

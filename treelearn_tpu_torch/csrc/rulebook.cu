// Submanifold rulebook from sorted int32 voxel keys.
//
// Replaces the Pallas kernel _rd_kernel (treelearn_tpu/ops/pallas_rd.py:68).
// Keys are ((b*sx + x)*sy + y)*sz + z, sorted ascending, unique.  For every
// (offset k, voxel i) one thread decodes voxel i, rejects offsets that leave
// the grid on x, y or z (the guards of pallas_rd.py:185-198: a bare key
// delta cannot tell (x, y, 0) - 1 from (x, y-1, sz-1), nor the last x row of
// one batch element from the first of the next), and binary-searches the
// neighbor key.  Output rule[k][i] = slot of the neighbor or -1; offset
// order is dx slowest, dz fastest (ops/sparse.py:kernel_offsets).
//
// Bound: memory.  Per voxel 4 B of keys are read and 27 x 4 B of rule are
// written; consecutive threads write consecutive i of one offset row, so
// the stores coalesce, and the searches of neighboring voxels walk the same
// key ranges, which stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void rulebook_kernel(const int32_t* __restrict__ keys, int v,
                                int sx, int sy, int sz,
                                int32_t* __restrict__ rule) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)27 * v;
  if (tid >= total) return;
  const int k = (int)(tid / v);
  const int i = (int)(tid - (int64_t)k * v);
  const int dx = k / 9 - 1;
  const int dy = (k / 3) % 3 - 1;
  const int dz = k % 3 - 1;

  const int32_t key = keys[i];
  const int z = key % sz;
  const int r = key / sz;
  const int y = r % sy;
  const int x = (r / sy) % sx;

  int32_t out = -1;
  const int nx = x + dx, ny = y + dy, nz = z + dz;
  if (nx >= 0 && nx < sx && ny >= 0 && ny < sy && nz >= 0 && nz < sz) {
    const int64_t target = (int64_t)key + (int64_t)dx * sy * sz +
                           (int64_t)dy * sz + dz;
    // lower_bound over keys[0, v)
    int lo = 0, hi = v;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if ((int64_t)keys[mid] < target) lo = mid + 1; else hi = mid;
    }
    if (lo < v && (int64_t)keys[lo] == target) out = lo;
  }
  rule[tid] = out;
}

}  // namespace

extern "C" int tl_rulebook(const void* keys, int v, int sx, int sy, int sz,
                           void* rule, void* stream) {
  const int threads = 256;
  const int64_t total = (int64_t)27 * v;
  const int64_t blocks = (total + threads - 1) / threads;
  rulebook_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, v, sx, sy, sz, (int32_t*)rule);
  return (int)cudaGetLastError();
}

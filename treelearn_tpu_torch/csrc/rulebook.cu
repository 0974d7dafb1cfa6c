// Submanifold rulebook from sorted int32 voxel keys, in band form.
//
// Replaces the Pallas kernel _rd_kernel (treelearn_tpu/ops/pallas_rd.py:68).
// Keys are ((b*sx + x)*sy + y)*sz + z, sorted ascending, unique.  Output
// rule[k][i] = slot of voxel i's neighbor at offset k or -1; offset order is
// dx slowest, dz fastest (ops/sparse.py:kernel_offsets).
//
// z is the fastest key digit, so the three dz neighbors of one (dx, dy)
// band have the adjacent keys T-1, T, T+1 (T = key + dx*sy*sz + dy*sz) and,
// being adjacent keys of a sorted unique array, sit in consecutive slots.
// One thread per (band, voxel) therefore runs one lower_bound(T-1) -> p and
// matches keys[p], keys[p+1], keys[p+2] against the three targets by key (an
// absent target shifts the later ones down a slot).  The centre band needs
// no search: its candidates are slots i-1, i, i+1.  That is 8 searches a
// voxel instead of 27, and a band with dx or dy < 0 searches only [0, i),
// the others only (i, V).  The TPU kernel works in the same bands
// (pallas_rd.py:145).
//
// The guards of pallas_rd.py:185-198 apply on the query side, because a key
// difference alone cannot tell (x, y, 0) - 1 from (x, y-1, sz-1), nor the
// last x row of one batch element from the first of the next: a band is
// rejected when x+dx or y+dy leaves the grid, dz = -1 when z = 0, dz = +1
// when z = sz-1.
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
  if (tid >= (int64_t)9 * v) return;
  const int band = (int)(tid / v);
  const int i = (int)(tid - (int64_t)band * v);
  const int dx = band / 3 - 1;
  const int dy = band % 3 - 1;

  const int32_t key = keys[i];
  const int z = key % sz;
  const int r = key / sz;
  const int y = r % sy;
  const int x = (r / sy) % sx;

  int32_t found[3] = {-1, -1, -1};
  const int nx = x + dx, ny = y + dy;
  if (nx >= 0 && nx < sx && ny >= 0 && ny < sy) {
    // key of the dz = -1 target
    const int64_t first = (int64_t)key + (int64_t)dx * sy * sz +
                          (int64_t)dy * sz - 1;
    int p;
    if (band == 4) {
      p = i - 1;
    } else {
      int lo = band < 4 ? 0 : i + 1;
      int hi = band < 4 ? i : v;
      while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if ((int64_t)keys[mid] < first) lo = mid + 1; else hi = mid;
      }
      p = lo;
    }
    const bool z_ok[3] = {z > 0, true, z < sz - 1};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int slot = p + j;
      if (slot < 0 || slot >= v) continue;
      const int64_t d = (int64_t)keys[slot] - first;
#pragma unroll
      for (int dz = 0; dz < 3; ++dz)
        if (d == dz && z_ok[dz]) found[dz] = slot;
    }
  }
#pragma unroll
  for (int dz = 0; dz < 3; ++dz)
    rule[(int64_t)(band * 3 + dz) * v + i] = found[dz];
}

// The 27-probe form this file held before the band form: one thread per
// (offset, voxel), each with its own binary search over all keys.  Kept as
// the yardstick the band form is timed against on the card.
__global__ void rulebook_probes_kernel(const int32_t* __restrict__ keys, int v,
                                       int sx, int sy, int sz,
                                       int32_t* __restrict__ rule) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)27 * v) return;
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
    int lo = 0, hi = v;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if ((int64_t)keys[mid] < target) lo = mid + 1; else hi = mid;
    }
    if (lo < v && (int64_t)keys[lo] == target) out = lo;
  }
  rule[tid] = out;
}

template <int ROWS, typename K>
int launch(K kernel, const void* keys, int v, int sx, int sy, int sz,
           void* rule, void* stream) {
  const int threads = 256;
  const int64_t total = (int64_t)ROWS * v;
  const int64_t blocks = (total + threads - 1) / threads;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, v, sx, sy, sz, (int32_t*)rule);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tl_rulebook(const void* keys, int v, int sx, int sy, int sz,
                           void* rule, void* stream) {
  return launch<9>(rulebook_kernel, keys, v, sx, sy, sz, rule, stream);
}

extern "C" int tl_rulebook_probes(const void* keys, int v, int sx, int sy,
                                  int sz, void* rule, void* stream) {
  return launch<27>(rulebook_probes_kernel, keys, v, sx, sy, sz, rule, stream);
}

// Eps-graph found bits for DBSCAN-mode grouping.
//
// Replaces the Pallas kernel _cc_kernel (treelearn_tpu/ops/pallas_cc.py:51).
// With xy cells of eps / sqrt(2) every cell is a clique, and an eps-ball
// reaches at most two cells per axis, so a point's edges are summarised by
// 25 bits: bit (di + 2) * 5 + (dj + 2) is set when cell (i + di, j + dj)
// holds a point within eps.  The TPU kernel masks five banded windows per
// tile of 64 points, with a window-overflow fallback.  Here the points are
// sorted by cell key (key = i * width + j), cell_keys holds the sorted
// unique keys and cell_start each cell's first sorted row.  The union-find
// over cell representatives runs on the host (ops/cc.py), as at
// pallas_cc.py:280-319.
//
// The distance test d2 = dx*dx + dy*dy <= eps2 is rounded step by step
// (__fmul_rn / __fadd_rn, no FMA contraction), as the plain PyTorch
// version computes it, so points on the eps circle decide identically.
//
// Bound on the card: memory (8 B of coordinates read and 4 B written per
// point, 28 B a cell).  The first version, one thread a point, was far
// from it: every point ran 25 binary searches over the cell keys, though
// which cells neighbor a cell is the same for all its points; a neighbor
// cell that holds nothing within eps was read to its end by every point,
// which on offset-shifted coordinates under a trained head is thousands of
// points a cell; and the lanes of a warp sat in different cells with
// different walks.  The design:
//
// * A warp serves one work item of ops/cc.py:cell_items: up to 32 points of
//   one cell.  Eight items share a block; nothing is block-wide.
// * The neighbor cells are looked up once per item, in band form: the keys
//   of cells (i + di, j - 2 .. j + 2) are consecutive integers, so lane di
//   finds the lower bound of the row's first key (clipped to the grid's
//   columns) and looks at the five entries from there; the own row needs no
//   search, its cells lie within two entries of the cell itself.  Four
//   searches a cell in parallel lanes instead of 25 a point.  Each found
//   cell's row range and bounding box go to shared memory.
// * The own cell's bit is set without a walk (the point itself).
// * Before a neighbor cell is walked, each lane tests its point against the
//   bounding box of that cell's points.  The lower bound on d2 goes through
//   the same rounded steps as the distance (subtract, square, add: each
//   monotone), so it never exceeds the computed d2 of a point of the box and
//   cannot reject a true hit.  A cell no lane needs is not read.
// * A walked cell is staged through shared memory 32 points at a time (one
//   coalesced asynchronous copy a tile, the next tile in flight while this
//   one is scanned).  The item's n points take qs lanes (the power of
//   two that holds n) and the warp's other lanes split the tile 32 / qs ways
//   (lane l: point l % qs, records l / qs, l / qs + 32 / qs, ...): the median
//   cell of a plot holds four points, and a lane a point would leave most of
//   the warp idle.  Lanes of one partition read the same record (a
//   broadcast), four records a step so that the tests overlap.  After each
//   tile the partitions of a point combine their hits by an xor-shuffle
//   tree; a point stops testing once it has a hit and the warp stops staging
//   once no point needs the cell.
//
// What is left (H100, the plot's problem, a few points a cell): about a
// hundred instructions a neighbor cell whatever it holds, twenty cells an
// item.  Staging all the neighbor cells of a sparse item at once and
// sweeping them as one sequence, without box test or early exit, took the
// same time (more tests, less overhead), so it is not here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 8-byte asynchronous copy global -> shared: the issuing lane does not wait
// for the data, so a run of copies costs one memory latency, not one each
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
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

constexpr int WARPS = 8;   // items a block serves
constexpr unsigned FULL = 0xffffffffu;
// a staged tile holds 32 records; the walk reads four at a time at a stride
// of up to 32, so up to record 32 + 3 * 32: the rest of the tile holds NaN,
// which is within eps of nothing
constexpr int TILE_PAD = 128;

__global__ void __launch_bounds__(WARPS * 32)
cc_cell_kernel(const float2* __restrict__ pts,
               const int32_t* __restrict__ cell_keys,
               const int32_t* __restrict__ cell_start,
               const float4* __restrict__ cell_box,
               const int32_t* __restrict__ items, int n_items, int n_cells,
               int width, float eps2, int32_t* __restrict__ out) {
  __shared__ int nbr_s[WARPS][25];
  __shared__ int nbr_e[WARPS][25];
  __shared__ float4 nbr_box[WARPS][25];
  __shared__ float2 tiles[WARPS][2 * TILE_PAD];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * WARPS + warp;
  if (item >= n_items) return;   // the whole warp: no block-wide barrier below
  const int c = items[3 * item];
  const int p0 = items[3 * item + 1];
  const int n = items[3 * item + 2];

  if (lane < 25) {
    nbr_s[warp][lane] = 0;
    nbr_e[warp][lane] = 0;
  }
  __syncwarp();
  if (lane < 5) {
    const int key = cell_keys[c];
    const int cj = key % width;
    const int row = key / width + lane - 2;
    if (row >= 0) {   // a row past the last one matches no key
      const int center = row * width + cj;
      const int k_lo = center - min(cj, 2);
      const int k_hi = center + min(width - 1 - cj, 2);
      int first;
      if (lane == 2) {
        first = max(c - 2, 0);
      } else {
        int lo = 0, hi = n_cells;
        while (lo < hi) {
          const int mid = lo + ((hi - lo) >> 1);
          if (cell_keys[mid] < k_lo) lo = mid + 1; else hi = mid;
        }
        first = lo;
      }
      for (int e = 0; e < 5; ++e) {
        const int idx = first + e;
        if (idx >= n_cells) break;
        const int k = cell_keys[idx];
        if (k > k_hi) break;
        if (k >= k_lo) {
          const int b = lane * 5 + (k - center + 2);
          nbr_s[warp][b] = cell_start[idx];
          nbr_e[warp][b] = cell_start[idx + 1];
          nbr_box[warp][b] = cell_box[idx];
        }
      }
    }
  }
  __syncwarp();

  // n points x 32 / qs partitions of a walked cell's records: most cells of
  // a plot hold a few points, and the other lanes would idle
  const int qs = n <= 1 ? 1 : 1 << (32 - __clz(n - 1));   // power of two >= n
  const int parts = 32 / qs;
  const int ql = lane & (qs - 1);
  const int part = lane >> (__ffs(qs) - 1);
  const bool has = ql < n;
  const int p = p0 + (has ? ql : 0);
  const float2 me = pts[p];
  float2* tile = tiles[warp];
  const float nan = __int_as_float(0x7fc00000);
  int32_t mask = 1 << 12;   // the own cell holds the point itself
  const int mine = min(lane, 24);
  unsigned exist = __ballot_sync(
      FULL, lane < 25 && lane != 12 && nbr_e[warp][mine] > nbr_s[warp][mine]);

  // cell by cell: box test first, then 32 records a tile (two buffers, the
  // next tile in flight while this one is scanned), done with a cell as soon
  // as every point that needs it has a hit
  for (int i = 32 + lane; i < 2 * TILE_PAD; i += 32)
    if ((i & (TILE_PAD - 1)) >= 32) tile[i] = make_float2(nan, nan);
  auto stage = [&](int buf, int base, int e) {
    float2* dst = tile + buf * TILE_PAD + lane;
    if (base + lane < e) cp_async8(dst, pts + base + lane);
    else *dst = make_float2(nan, nan);
    cp_async_commit();
  };
  while (exist) {           // the neighbor cells that exist: warp-uniform
    const int b = __ffs(exist) - 1;
    exist &= exist - 1;
    const int s = nbr_s[warp][b], e = nbr_e[warp][b];
    const float4 box = nbr_box[warp][b];
    const float bx = fmaxf(fmaxf(__fsub_rn(box.x, me.x), __fsub_rn(me.x, box.z)),
                           0.f);
    const float by = fmaxf(fmaxf(__fsub_rn(box.y, me.y), __fsub_rn(me.y, box.w)),
                           0.f);
    const bool wanted =
        has && __fadd_rn(__fmul_rn(bx, bx), __fmul_rn(by, by)) <= eps2;
    bool need = wanted;     // the same in every partition of a point
    if (!__any_sync(FULL, need)) continue;
    stage(0, s, e);
    for (int base = s, t = 0; base < e; base += 32, ++t) {
      if (base + 32 < e) {
        stage((t + 1) & 1, base + 32, e);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();   // tile t has landed for every lane
      const float2* cur = tile + (t & 1) * TILE_PAD;
      const int n_in = min(32, e - base);
      bool hit = false;
      for (int k = part; k < n_in; k += 4 * parts) {
        // four independent tests a step: the walk of a dense cell is one
        // lane's chain of dependent instructions, and this is its length
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 r = cur[k + u * parts];
          const float dx = __fsub_rn(r.x, me.x);
          const float dy = __fsub_rn(r.y, me.y);
          hit |= __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= eps2;
        }
      }
      need &= !hit;
      // a hit in any partition of a point ends the walk for all of them
      for (int d = 16; d >= qs; d >>= 1)
        need &= (bool)__shfl_xor_sync(FULL, (int)need, d);
      __syncwarp();   // tile t may be refilled
      if (!__any_sync(FULL, need)) break;
    }
    cp_async_wait<0>();   // a tile may be in flight when the walk ends early
    __syncwarp();
    if (wanted && !need) mask |= 1 << b;
  }
  if (has && part == 0) out[p] = mask;
}

}  // namespace

// pts (N, 2) float32 sorted by cell key, cell_keys (C,) int32, cell_start
// (C + 1,) int32, cell_box (C, 4) float32, items (n_items, 3) int32 rows
// (cell, first point, points <= 32) that hold every point once; out (N,)
// int32.  (i_max + 3) * width must fit int32 (ops/cc.py:prepare checks).
extern "C" int tl_cc_found_bits(const void* pts, const void* cell_keys,
                                const void* cell_start, const void* cell_box,
                                const void* items, int n_items, int n_cells,
                                int width, float eps2, void* out,
                                void* stream) {
  const int blocks = (n_items + WARPS - 1) / WARPS;
  cc_cell_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float2*)pts, (const int32_t*)cell_keys,
      (const int32_t*)cell_start, (const float4*)cell_box,
      (const int32_t*)items, n_items, n_cells, width, eps2, (int32_t*)out);
  return (int)cudaGetLastError();
}

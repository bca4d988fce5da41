// Ragged WCSD query kernels over the lane-tiled label arena.
//
// Replaces: src/repro/kernels/wcsd_query.py:wcsd_query_ragged (K1) and
//           src/repro/kernels/wcsd_query.py:wcsd_profile_ragged (K2).
//
// Per worklist item k = (qidx, s_tile, t_tile): the min over hub meets
// hub_s[i] == hub_t[j] of dist_s[i] + dist_t[j], both clamped to DEV_INF
// (K1: masked to DEV_INF where wlev < wq[qidx]; K2: binned by the pair
// level min(wlev_s, wlev_t) into num_levels + 1 minima), min-accumulated
// into output row qidx.
//
// What bounds it on the H100: integer operations, not bytes. Each item
// reads 2 tiles (3 int32 x lane each, 3 KB at lane 128) and does lane^2
// compare/add/min (16K at lane 128): ~5 int ops per byte read, against
// about 1 op per byte (int32 ALU rate / HBM rate) where the card turns
// compute-bound. Items whose [tile_lo, tile_hi] hub spans are disjoint
// cannot meet and are skipped before any tile is read.
//
// Design: the Pallas kernel walks the worklist as a sequential grid,
// initialising out[qidx] on each query's first item and accumulating into
// the same output block on the following steps. Hopper blocks run in no
// order, so here each work item is one block: it stages the t-side tile
// (hub + masked dist; K2 also wlev) in shared memory, each thread owns one
// s-side cell and scans the staged tile, the block reduces with warp
// shuffles, and one thread ends with an atomicMin into out. The wrapper
// pre-fills out with DEV_INF (trash row included); int32 min is
// order-independent, so the result is bit-exact whatever order blocks
// run in, and the worklist's `first` flags are not needed. The TPU's
// DMA ring has no counterpart yet (cp.async/TMA staging is later work).
#include <cuda_runtime.h>
#include <stdint.h>

#define DEV_INF (1 << 29)
#define MAX_LEVELS1 32  // most num_levels + 1 the profile kernel bins

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide min; the result is valid in thread 0.
__device__ __forceinline__ int block_min(int v, int* scratch) {
  const int warp = threadIdx.x >> 5, lane_id = threadIdx.x & 31;
  v = warp_min(v);
  if (lane_id == 0) scratch[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < nwarps) ? scratch[threadIdx.x] : DEV_INF;
  if (warp == 0) v = warp_min(v);
  return v;
}

__device__ __forceinline__ bool tiles_meet(const int* tile_lo,
                                           const int* tile_hi, int s, int t) {
  return tile_lo[s] <= tile_hi[t] && tile_lo[t] <= tile_hi[s];
}

__global__ void wcsd_query_ragged_kernel(
    const int* __restrict__ hub, const int* __restrict__ dist,
    const int* __restrict__ wlev, const int* __restrict__ tile_lo,
    const int* __restrict__ tile_hi, const int* __restrict__ qidx,
    const int* __restrict__ stile, const int* __restrict__ ttile,
    const int* __restrict__ wq, int* __restrict__ out, int lane) {
  extern __shared__ int smem[];
  int* sh_hub = smem;             // [lane]
  int* sh_dist = smem + lane;     // [lane] masked, clamped
  __shared__ int red[32];
  const int64_t k = blockIdx.x;
  const int s = stile[k], t = ttile[k];
  if (!tiles_meet(tile_lo, tile_hi, s, t)) return;  // block-uniform
  const int q = qidx[k];
  const int w = wq[q];
  const int64_t tb = (int64_t)t * lane, sb = (int64_t)s * lane;
  for (int j = threadIdx.x; j < lane; j += blockDim.x) {
    sh_hub[j] = hub[tb + j];
    sh_dist[j] = wlev[tb + j] >= w ? min(dist[tb + j], DEV_INF) : DEV_INF;
  }
  __syncthreads();
  int best = DEV_INF;
  for (int i = threadIdx.x; i < lane; i += blockDim.x) {
    const int hs = hub[sb + i];
    const int ds = wlev[sb + i] >= w ? min(dist[sb + i], DEV_INF) : DEV_INF;
    for (int j = 0; j < lane; ++j)
      if (sh_hub[j] == hs) best = min(best, ds + sh_dist[j]);
  }
  best = block_min(best, red);
  if (threadIdx.x == 0 && best < DEV_INF) atomicMin(out + q, best);
}

__global__ void wcsd_profile_ragged_kernel(
    const int* __restrict__ hub, const int* __restrict__ dist,
    const int* __restrict__ wlev, const int* __restrict__ tile_lo,
    const int* __restrict__ tile_hi, const int* __restrict__ qidx,
    const int* __restrict__ stile, const int* __restrict__ ttile,
    int* __restrict__ out, int lane, int levels1) {
  extern __shared__ int smem[];
  int* sh_hub = smem;              // [lane]
  int* sh_dist = smem + lane;      // [lane] clamped
  int* sh_wlev = smem + 2 * lane;  // [lane]
  __shared__ int red[32];
  __shared__ int lev_min[MAX_LEVELS1];
  const int64_t k = blockIdx.x;
  const int s = stile[k], t = ttile[k];
  if (!tiles_meet(tile_lo, tile_hi, s, t)) return;  // block-uniform
  const int q = qidx[k];
  const int64_t tb = (int64_t)t * lane, sb = (int64_t)s * lane;
  for (int j = threadIdx.x; j < lane; j += blockDim.x) {
    sh_hub[j] = hub[tb + j];
    sh_dist[j] = min(dist[tb + j], DEV_INF);
    sh_wlev[j] = wlev[tb + j];
  }
  __syncthreads();
  int acc[MAX_LEVELS1];
  for (int l = 0; l < levels1; ++l) acc[l] = DEV_INF;
  for (int i = threadIdx.x; i < lane; i += blockDim.x) {
    const int hs = hub[sb + i];
    const int ds = min(dist[sb + i], DEV_INF);
    const int ws = wlev[sb + i];
    for (int j = 0; j < lane; ++j) {
      if (sh_hub[j] != hs) continue;
      const int mw = min(ws, sh_wlev[j]);
      if (mw >= 0 && mw < levels1) acc[mw] = min(acc[mw], ds + sh_dist[j]);
    }
  }
  for (int l = 0; l < levels1; ++l) {
    const int m = block_min(acc[l], red);
    if (threadIdx.x == 0) lev_min[l] = m;
    __syncthreads();  // red is reused by the next level's reduction
  }
  if (threadIdx.x < levels1 && lev_min[threadIdx.x] < DEV_INF)
    atomicMin(out + (int64_t)q * levels1 + threadIdx.x, lev_min[threadIdx.x]);
}

static int block_threads(int lane) {
  int th = ((lane + 31) / 32) * 32;
  return th > 1024 ? 1024 : th;
}

extern "C" int wcsd_query_ragged_launch(
    const void* hub, const void* dist, const void* wlev, const void* tile_lo,
    const void* tile_hi, const void* qidx, const void* stile,
    const void* ttile, const void* wq, void* out, long long worklist_len,
    int lane, void* stream) {
  if (worklist_len <= 0) return 0;
  const size_t smem = 2 * (size_t)lane * sizeof(int);
  wcsd_query_ragged_kernel<<<(unsigned)worklist_len, block_threads(lane),
                             smem, (cudaStream_t)stream>>>(
      (const int*)hub, (const int*)dist, (const int*)wlev,
      (const int*)tile_lo, (const int*)tile_hi, (const int*)qidx,
      (const int*)stile, (const int*)ttile, (const int*)wq, (int*)out, lane);
  return (int)cudaGetLastError();
}

extern "C" int wcsd_profile_ragged_launch(
    const void* hub, const void* dist, const void* wlev, const void* tile_lo,
    const void* tile_hi, const void* qidx, const void* stile,
    const void* ttile, void* out, long long worklist_len, int lane,
    int levels1, void* stream) {
  if (worklist_len <= 0) return 0;
  if (levels1 < 1 || levels1 > MAX_LEVELS1) return (int)cudaErrorInvalidValue;
  const size_t smem = 3 * (size_t)lane * sizeof(int);
  wcsd_profile_ragged_kernel<<<(unsigned)worklist_len, block_threads(lane),
                               smem, (cudaStream_t)stream>>>(
      (const int*)hub, (const int*)dist, (const int*)wlev,
      (const int*)tile_lo, (const int*)tile_hi, (const int*)qidx,
      (const int*)stile, (const int*)ttile, (int*)out, lane, levels1);
  return (int)cudaGetLastError();
}

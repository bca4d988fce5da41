// WCSD query kernels: the ragged kernels over the lane-tiled label arena
// (plain and compressed), the bucket-pair kernels over padded bucket
// tiles and the gathered-row kernel of the padded store, all on one join
// body.
//
// Replaces: src/repro/kernels/wcsd_query.py:wcsd_query_ragged (K1),
//           ...:wcsd_profile_ragged (K2),
//           ...:wcsd_query_ragged_compressed (K5),
//           ...:wcsd_profile_ragged_compressed (K6),
//           ...:wcsd_query_segmented (K7),
//           ...:wcsd_profile_segmented (K8) and
//           ...:wcsd_query_gathered (K9).
//
// The join: the min over hub meets hub_s[i] == hub_t[j] of dist_s[i] +
// dist_t[j], both clamped to DEV_INF. The scalar kernels (K1, K5, K7)
// mask a cell's distance to DEV_INF where its wlev < the query's level;
// the profile kernels (K2, K6, K8) take no level and bin every meet's sum
// by its pair level min(wlev_s, wlev_t) into num_levels + 1 minima (the
// wrapper turns them into staircases). A block stages its t-side cells
// (hub + dist, profile also wlev) in shared memory, each thread takes
// s-side cells with a stride of blockDim.x and scans the staged cells,
// and the block reduces with warp shuffles. Every kernel reads its cells
// through a cell reader, so the join is written once:
//
// - Int32Cells: int32 hub / dist / wlev (the arena, the bucket tiles).
// - GatheredCells: K9's pre-gathered rows, distances already masked to
//   DEV_INF and clamped by the wrapper: read as they are, every cell
//   feasible.
// - CompressedCells<F>: the compressed arena (int16 hub deltas, bf16 or
//   fp16 distances, int8 levels: 5 bytes a cell instead of 12), decoded
//   in registers as each cell is loaded, exactly as the reference's
//   `_decode_cells`: hub = tile_lo + delta where delta >= 0, else -1 (the
//   pad flag); dist = min(float(x), DEV_INF) + 0.5 rounded to nearest,
//   then truncated (`__float2int_rz`, as `astype(int32)` truncates), so
//   +inf pads decode to DEV_INF; wlev widened. The staged cells are
//   decoded int32 values. Built without fast math.
//
// Ragged (K1, K2, K5, K6), per worklist item k = (qidx, s_tile, t_tile):
// the join of the two tiles, min-accumulated into output row qidx. The
// Pallas kernel walks the worklist as a sequential grid, initialising
// out[qidx] on each query's first item and accumulating into the same
// output block on the following steps. Hopper blocks run in no order, so
// here each work item is one block ending in one atomicMin per output
// cell. The wrapper pre-fills out with DEV_INF (trash row included); int32
// min is order-independent, so the result is bit-exact whatever order
// blocks run in, and the worklist's `first` flags are not needed. Items
// whose [tile_lo, tile_hi] hub spans are disjoint cannot meet and are
// skipped before any cell is read.
//
// Bucket-pair (K7, K8), per query b of one planned sub-batch: the join of
// row srow[b] of the s-side tiles [Ns, Ws] with row trow[b] of the t-side
// tiles [Nt, Wt] (pads hub -1, dist INF_DIST, wlev -1). The Pallas kernel
// walks a (query, t-block) grid and accumulates across t-blocks;
// `_fit_block` exists only so that the block divides Wt. Here one block
// owns one query, so nothing is carried between blocks and no atomics are
// needed: the block stages its t-row in chunks of T_CHUNK cells (the loop
// bound masks the ragged edge). There is no span test: every cell pair of
// the two padded rows is joined, as in the reference.
//
// Gathered (K9), per query b of a [B, L] batch: the join of row b of hs/ds
// with row b of ht/dt. The Pallas kernel walks a (query block, t-block)
// grid and carries the min across t-blocks in its output block, which
// it initialises to DEV_INF; the wrapper pads B to 8 and L to 128. Here,
// as for K7, one block owns one query and stages its t-row in chunks of
// T_CHUNK cells, so any B and L are taken as they are. The accumulator
// starts at DEV_INF, so the output never exceeds it, and since ds and dt
// lie in [0, DEV_INF] no sum overflows int32. Rows need not be
// hub-sorted (the contract does not promise it), so this is the
// all-pairs join. On the padded store every query pays the global
// longest row's L^2 compares: that is the layout's cost, not the
// kernel's.
//
// Every kernel compares all cell pairs it joins (lane^2 per tile pair,
// Ws x Wt per query). Rows are hub-sorted with repeated hubs, so a merge
// join would do O(Ws + Wt) steps plus the meets; it is later work. The
// TPU's DMA ring has no counterpart yet (cp.async/TMA staging is later
// work).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DEV_INF (1 << 29)
#define MAX_LEVELS1 32     // most num_levels + 1 the profile kernels bin
#define T_CHUNK 2048       // bucket-pair t-row cells staged at a time
#define MAX_THREADS_SEG 256

// ------------------------------------------------------------ cell readers
struct Int32Cells {
  const int* __restrict__ hub;
  const int* __restrict__ dist;
  const int* __restrict__ wlev;
  __device__ __forceinline__ int hub_at(int64_t x, int) const {
    return hub[x];
  }
  __device__ __forceinline__ int dist_at(int64_t x) const {
    return min(dist[x], DEV_INF);
  }
  __device__ __forceinline__ int wlev_at(int64_t x) const { return wlev[x]; }
};

struct GatheredCells {
  const int* __restrict__ hub;
  const int* __restrict__ dist;
  __device__ __forceinline__ int hub_at(int64_t x, int) const {
    return hub[x];
  }
  __device__ __forceinline__ int dist_at(int64_t x) const { return dist[x]; }
  __device__ __forceinline__ int wlev_at(int64_t) const { return 0; }
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename F>
struct CompressedCells {
  const short* __restrict__ hub_delta;
  const F* __restrict__ dist;
  const signed char* __restrict__ wlev;
  __device__ __forceinline__ int hub_at(int64_t x, int lo) const {
    const short d = hub_delta[x];
    return d >= 0 ? lo + (int)d : -1;
  }
  __device__ __forceinline__ int dist_at(int64_t x) const {
    return __float2int_rz(
        __fadd_rn(fminf(to_f32(dist[x]), (float)DEV_INF), 0.5f));
  }
  __device__ __forceinline__ int wlev_at(int64_t x) const {
    return (int)wlev[x];
  }
};

// ------------------------------------------------------------- reductions
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

// Block-wide min of every level's accumulator into lev_min[levels1]
// (shared), valid in every thread on return.
__device__ __forceinline__ void block_min_levels(const int* acc, int levels1,
                                                 int* scratch, int* lev_min) {
  for (int l = 0; l < levels1; ++l) {
    const int m = block_min(acc[l], scratch);
    if (threadIdx.x == 0) lev_min[l] = m;
    __syncthreads();  // scratch is reused by the next level's reduction
  }
}

// ------------------------------------------------------------ the join
// Stage cells [base, base + n): hub, and dist masked to DEV_INF where
// wlev < w (scalar kernels).
template <typename Cells>
__device__ __forceinline__ void stage_masked(const Cells& c, int64_t base,
                                             int n, int lo, int w,
                                             int* sh_hub, int* sh_dist) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sh_hub[j] = c.hub_at(base + j, lo);
    sh_dist[j] = c.wlev_at(base + j) >= w ? c.dist_at(base + j) : DEV_INF;
  }
}

// This thread's s-cells of [base, base + ns) against the n staged cells:
// the min over hub meets, folded into best.
template <typename Cells>
__device__ __forceinline__ int join_masked(const Cells& c, int64_t base,
                                           int ns, int lo, int w,
                                           const int* sh_hub,
                                           const int* sh_dist, int n,
                                           int best) {
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const int hs = c.hub_at(base + i, lo);
    const int ds = c.wlev_at(base + i) >= w ? c.dist_at(base + i) : DEV_INF;
    for (int j = 0; j < n; ++j)
      if (sh_hub[j] == hs) best = min(best, ds + sh_dist[j]);
  }
  return best;
}

// Stage cells [base, base + n): hub, dist and wlev (profile kernels).
template <typename Cells>
__device__ __forceinline__ void stage_levels(const Cells& c, int64_t base,
                                             int n, int lo, int* sh_hub,
                                             int* sh_dist, int* sh_wlev) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sh_hub[j] = c.hub_at(base + j, lo);
    sh_dist[j] = c.dist_at(base + j);
    sh_wlev[j] = c.wlev_at(base + j);
  }
}

// This thread's s-cells against the n staged cells, each meet's sum
// min-accumulated into acc at its pair level.
template <typename Cells>
__device__ __forceinline__ void join_levels(const Cells& c, int64_t base,
                                            int ns, int lo,
                                            const int* sh_hub,
                                            const int* sh_dist,
                                            const int* sh_wlev, int n,
                                            int* acc, int levels1) {
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const int hs = c.hub_at(base + i, lo);
    const int ds = c.dist_at(base + i);
    const int ws = c.wlev_at(base + i);
    for (int j = 0; j < n; ++j) {
      if (sh_hub[j] != hs) continue;
      const int mw = min(ws, sh_wlev[j]);
      if (mw >= 0 && mw < levels1) acc[mw] = min(acc[mw], ds + sh_dist[j]);
    }
  }
}

// --------------------------------------------- ragged (K1, K2, K5, K6)
__device__ __forceinline__ bool tiles_meet(const int* tile_lo,
                                           const int* tile_hi, int s, int t) {
  return tile_lo[s] <= tile_hi[t] && tile_lo[t] <= tile_hi[s];
}

template <typename Cells>
__global__ void wcsd_query_ragged_kernel(
    Cells c, const int* __restrict__ tile_lo, const int* __restrict__ tile_hi,
    const int* __restrict__ qidx, const int* __restrict__ stile,
    const int* __restrict__ ttile, const int* __restrict__ wq,
    int* __restrict__ out, int lane) {
  extern __shared__ int smem[];
  int* sh_hub = smem;          // [lane]
  int* sh_dist = smem + lane;  // [lane] masked, clamped
  __shared__ int red[32];
  const int64_t k = blockIdx.x;
  const int s = stile[k], t = ttile[k];
  if (!tiles_meet(tile_lo, tile_hi, s, t)) return;  // block-uniform
  const int q = qidx[k];
  const int w = wq[q];
  stage_masked(c, (int64_t)t * lane, lane, tile_lo[t], w, sh_hub, sh_dist);
  __syncthreads();
  int best = join_masked(c, (int64_t)s * lane, lane, tile_lo[s], w, sh_hub,
                         sh_dist, lane, DEV_INF);
  best = block_min(best, red);
  if (threadIdx.x == 0 && best < DEV_INF) atomicMin(out + q, best);
}

template <typename Cells>
__global__ void wcsd_profile_ragged_kernel(
    Cells c, const int* __restrict__ tile_lo, const int* __restrict__ tile_hi,
    const int* __restrict__ qidx, const int* __restrict__ stile,
    const int* __restrict__ ttile, int* __restrict__ out, int lane,
    int levels1) {
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
  stage_levels(c, (int64_t)t * lane, lane, tile_lo[t], sh_hub, sh_dist,
               sh_wlev);
  __syncthreads();
  int acc[MAX_LEVELS1];
  for (int l = 0; l < levels1; ++l) acc[l] = DEV_INF;
  join_levels(c, (int64_t)s * lane, lane, tile_lo[s], sh_hub, sh_dist,
              sh_wlev, lane, acc, levels1);
  block_min_levels(acc, levels1, red, lev_min);
  if (threadIdx.x < levels1 && lev_min[threadIdx.x] < DEV_INF)
    atomicMin(out + (int64_t)q * levels1 + threadIdx.x, lev_min[threadIdx.x]);
}

// ----------------------------------------------- bucket-pair (K7, K8)
__global__ void wcsd_query_segmented_kernel(
    Int32Cells cs, Int32Cells ct, const int* __restrict__ srow,
    const int* __restrict__ trow, const int* __restrict__ wq,
    int* __restrict__ out, int Ws, int Wt) {
  __shared__ int sh_hub[T_CHUNK];
  __shared__ int sh_dist[T_CHUNK];  // masked, clamped
  __shared__ int red[32];
  const int64_t b = blockIdx.x;
  const int w = wq[b];
  const int64_t sb = (int64_t)srow[b] * Ws, tb = (int64_t)trow[b] * Wt;
  int best = DEV_INF;
  for (int c0 = 0; c0 < Wt; c0 += T_CHUNK) {
    const int n = min(T_CHUNK, Wt - c0);
    __syncthreads();  // the previous chunk is fully scanned
    stage_masked(ct, tb + c0, n, 0, w, sh_hub, sh_dist);
    __syncthreads();
    best = join_masked(cs, sb, Ws, 0, w, sh_hub, sh_dist, n, best);
  }
  best = block_min(best, red);
  if (threadIdx.x == 0) out[b] = best;
}

__global__ void wcsd_profile_segmented_kernel(
    Int32Cells cs, Int32Cells ct, const int* __restrict__ srow,
    const int* __restrict__ trow, int* __restrict__ out, int Ws, int Wt,
    int levels1) {
  __shared__ int sh_hub[T_CHUNK];
  __shared__ int sh_dist[T_CHUNK];  // clamped
  __shared__ int sh_wlev[T_CHUNK];
  __shared__ int red[32];
  __shared__ int lev_min[MAX_LEVELS1];
  const int64_t b = blockIdx.x;
  const int64_t sb = (int64_t)srow[b] * Ws, tb = (int64_t)trow[b] * Wt;
  int acc[MAX_LEVELS1];
  for (int l = 0; l < levels1; ++l) acc[l] = DEV_INF;
  for (int c0 = 0; c0 < Wt; c0 += T_CHUNK) {
    const int n = min(T_CHUNK, Wt - c0);
    __syncthreads();  // the previous chunk is fully scanned
    stage_levels(ct, tb + c0, n, 0, sh_hub, sh_dist, sh_wlev);
    __syncthreads();
    join_levels(cs, sb, Ws, 0, sh_hub, sh_dist, sh_wlev, n, acc, levels1);
  }
  block_min_levels(acc, levels1, red, lev_min);
  if (threadIdx.x < levels1)
    out[b * levels1 + threadIdx.x] = lev_min[threadIdx.x];
}

// ------------------------------------------------------------ gathered (K9)
__global__ void wcsd_query_gathered_kernel(GatheredCells cs, GatheredCells ct,
                                           int* __restrict__ out, int L) {
  __shared__ int sh_hub[T_CHUNK];
  __shared__ int sh_dist[T_CHUNK];
  __shared__ int red[32];
  const int64_t base = (int64_t)blockIdx.x * L;
  int best = DEV_INF;
  for (int c0 = 0; c0 < L; c0 += T_CHUNK) {
    const int n = min(T_CHUNK, L - c0);
    __syncthreads();  // the previous chunk is fully scanned
    stage_masked(ct, base + c0, n, 0, 0, sh_hub, sh_dist);
    __syncthreads();
    best = join_masked(cs, base, L, 0, 0, sh_hub, sh_dist, n, best);
  }
  best = block_min(best, red);
  if (threadIdx.x == 0) out[blockIdx.x] = best;
}

// ------------------------------------------------------------- launchers
static int block_threads(int cells, int most) {
  const int th = ((cells + 31) / 32) * 32;
  return th > most ? most : th;
}

template <typename Cells>
static int launch_query_ragged(Cells c, const void* tile_lo,
                               const void* tile_hi, const void* qidx,
                               const void* stile, const void* ttile,
                               const void* wq, void* out,
                               long long worklist_len, int lane,
                               void* stream) {
  if (worklist_len <= 0) return 0;
  const size_t smem = 2 * (size_t)lane * sizeof(int);
  wcsd_query_ragged_kernel<Cells>
      <<<(unsigned)worklist_len, block_threads(lane, 1024), smem,
         (cudaStream_t)stream>>>(
          c, (const int*)tile_lo, (const int*)tile_hi, (const int*)qidx,
          (const int*)stile, (const int*)ttile, (const int*)wq, (int*)out,
          lane);
  return (int)cudaGetLastError();
}

template <typename Cells>
static int launch_profile_ragged(Cells c, const void* tile_lo,
                                 const void* tile_hi, const void* qidx,
                                 const void* stile, const void* ttile,
                                 void* out, long long worklist_len, int lane,
                                 int levels1, void* stream) {
  if (worklist_len <= 0) return 0;
  if (levels1 < 1 || levels1 > MAX_LEVELS1) return (int)cudaErrorInvalidValue;
  const size_t smem = 3 * (size_t)lane * sizeof(int);
  wcsd_profile_ragged_kernel<Cells>
      <<<(unsigned)worklist_len, block_threads(lane, 1024), smem,
         (cudaStream_t)stream>>>(
          c, (const int*)tile_lo, (const int*)tile_hi, (const int*)qidx,
          (const int*)stile, (const int*)ttile, (int*)out, lane, levels1);
  return (int)cudaGetLastError();
}

static Int32Cells int32_cells(const void* hub, const void* dist,
                              const void* wlev) {
  return Int32Cells{(const int*)hub, (const int*)dist, (const int*)wlev};
}

template <typename F>
static CompressedCells<F> compressed_cells(const void* hub_delta,
                                           const void* dist,
                                           const void* wlev) {
  return CompressedCells<F>{(const short*)hub_delta, (const F*)dist,
                            (const signed char*)wlev};
}

extern "C" int wcsd_query_ragged_launch(
    const void* hub, const void* dist, const void* wlev, const void* tile_lo,
    const void* tile_hi, const void* qidx, const void* stile,
    const void* ttile, const void* wq, void* out, long long worklist_len,
    int lane, void* stream) {
  return launch_query_ragged(int32_cells(hub, dist, wlev), tile_lo, tile_hi,
                             qidx, stile, ttile, wq, out, worklist_len, lane,
                             stream);
}

extern "C" int wcsd_profile_ragged_launch(
    const void* hub, const void* dist, const void* wlev, const void* tile_lo,
    const void* tile_hi, const void* qidx, const void* stile,
    const void* ttile, void* out, long long worklist_len, int lane,
    int levels1, void* stream) {
  return launch_profile_ragged(int32_cells(hub, dist, wlev), tile_lo,
                               tile_hi, qidx, stile, ttile, out,
                               worklist_len, lane, levels1, stream);
}

// dist_is_fp16: 0 = bfloat16 distances, 1 = float16
extern "C" int wcsd_query_ragged_compressed_launch(
    const void* hub_delta, const void* dist, const void* wlev,
    const void* tile_lo, const void* tile_hi, const void* qidx,
    const void* stile, const void* ttile, const void* wq, void* out,
    long long worklist_len, int lane, int dist_is_fp16, void* stream) {
  if (dist_is_fp16)
    return launch_query_ragged(
        compressed_cells<__half>(hub_delta, dist, wlev), tile_lo, tile_hi,
        qidx, stile, ttile, wq, out, worklist_len, lane, stream);
  return launch_query_ragged(
      compressed_cells<__nv_bfloat16>(hub_delta, dist, wlev), tile_lo,
      tile_hi, qidx, stile, ttile, wq, out, worklist_len, lane, stream);
}

extern "C" int wcsd_profile_ragged_compressed_launch(
    const void* hub_delta, const void* dist, const void* wlev,
    const void* tile_lo, const void* tile_hi, const void* qidx,
    const void* stile, const void* ttile, void* out, long long worklist_len,
    int lane, int levels1, int dist_is_fp16, void* stream) {
  if (dist_is_fp16)
    return launch_profile_ragged(
        compressed_cells<__half>(hub_delta, dist, wlev), tile_lo, tile_hi,
        qidx, stile, ttile, out, worklist_len, lane, levels1, stream);
  return launch_profile_ragged(
      compressed_cells<__nv_bfloat16>(hub_delta, dist, wlev), tile_lo,
      tile_hi, qidx, stile, ttile, out, worklist_len, lane, levels1, stream);
}

extern "C" int wcsd_query_segmented_launch(
    const void* hub_s, const void* dist_s, const void* wlev_s,
    const void* hub_t, const void* dist_t, const void* wlev_t,
    const void* srow, const void* trow, const void* wq, void* out,
    long long batch, int Ws, int Wt, void* stream) {
  if (batch <= 0) return 0;
  wcsd_query_segmented_kernel<<<(unsigned)batch,
                                block_threads(Ws, MAX_THREADS_SEG), 0,
                                (cudaStream_t)stream>>>(
      int32_cells(hub_s, dist_s, wlev_s), int32_cells(hub_t, dist_t, wlev_t),
      (const int*)srow, (const int*)trow, (const int*)wq, (int*)out, Ws, Wt);
  return (int)cudaGetLastError();
}

extern "C" int wcsd_profile_segmented_launch(
    const void* hub_s, const void* dist_s, const void* wlev_s,
    const void* hub_t, const void* dist_t, const void* wlev_t,
    const void* srow, const void* trow, void* out, long long batch, int Ws,
    int Wt, int levels1, void* stream) {
  if (batch <= 0) return 0;
  if (levels1 < 1 || levels1 > MAX_LEVELS1) return (int)cudaErrorInvalidValue;
  wcsd_profile_segmented_kernel<<<(unsigned)batch,
                                  block_threads(Ws, MAX_THREADS_SEG), 0,
                                  (cudaStream_t)stream>>>(
      int32_cells(hub_s, dist_s, wlev_s), int32_cells(hub_t, dist_t, wlev_t),
      (const int*)srow, (const int*)trow, (int*)out, Ws, Wt, levels1);
  return (int)cudaGetLastError();
}

extern "C" int wcsd_query_gathered_launch(const void* hs, const void* ds,
                                          const void* ht, const void* dt,
                                          void* out, long long batch, int L,
                                          void* stream) {
  if (batch <= 0) return 0;
  if (L < 1) return (int)cudaErrorInvalidValue;
  wcsd_query_gathered_kernel<<<(unsigned)batch,
                               block_threads(L, MAX_THREADS_SEG), 0,
                               (cudaStream_t)stream>>>(
      GatheredCells{(const int*)hs, (const int*)ds},
      GatheredCells{(const int*)ht, (const int*)dt}, (int*)out, L);
  return (int)cudaGetLastError();
}

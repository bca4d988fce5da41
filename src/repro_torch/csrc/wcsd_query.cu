// WCSD query kernels: the ragged kernels over the lane-tiled label arena
// (plain and compressed), the bucket-pair kernels over padded bucket
// tiles and the gathered-row kernel of the padded store. All seven are
// merge joins.
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
// mask a cell's distance to DEV_INF where its wlev < the query's level
// (K9 takes distances the wrapper has masked); the profile kernels (K2,
// K6, K8) take no level and bin every meet's sum by its pair level
// min(wlev_s, wlev_t) into num_levels + 1 minima (the wrapper turns them
// into staircases).
//
// What bounds every one of them is bytes: each row or tile read once (12
// bytes a cell, 8 for K9's pre-masked rows, 5 compressed), the ids and
// the answers. The join itself needs one compare per cell of either side
// plus an add and a min (profile: and the bin) per hub meet, which a
// merge join over hub-sorted rows does. The store's rows are hub-sorted
// (it is written in (v, hub, d) order; arena tiles, bucket tiles and
// padded rows are slices of those rows with pads after them), but the
// reference does not promise it. So every merge kernel first checks the
// rows it joins: real cells (hub >= 0) non-decreasing in hub, pads (hub
// < 0) only after them, and every pad inert (a scalar pad's masked
// distance, at the query's level, is DEV_INF, so a pad meet never
// reaches below DEV_INF; a profile pad's wlev is < 0, so its meets fall
// in no bin). Rows that fail the check are joined all-pairs inside the
// kernel, as the reference joins them.
//
// Ragged (K1, K2, K5, K6), per worklist item k = (qidx, s_tile, t_tile):
// the join of the two tiles, min-accumulated into output row qidx. The
// Pallas kernel walks the worklist as a sequential grid, initialising
// out[qidx] on each query's first item and accumulating into the same
// output block on the following steps. Hopper blocks run in no order, so
// here every work item ends in atomicMin into its output row. The
// wrapper pre-fills out with DEV_INF (trash row included); int32 min is
// order-independent, so the result is bit-exact whatever order items run
// in, and the worklist's `first` flags are not needed. Items whose
// [tile_lo, tile_hi] hub spans are disjoint cannot meet and are skipped
// before any cell is read.
//
// One warp-per-item merge kernel per ragged join (scalar: K1 and K5;
// profile: K2 and K6), templated on a tile stager, so an item costs no
// block barrier: blocks of PROF_WARPS_MAX warps (fewer where the lane is
// wide), only as many as the card holds at once, each warp walking the
// worklist with the grid's stride (a block of 8 items, one each, holds
// its slot on the SM until its slowest item ends, while two in three
// items of a flush end at the span test). The stager fills the warp's
// slice of shared memory with both tiles as int32 cells (hub, dist,
// wlev: 1.5 KB a tile at lane 128):
//  * Int32Tiles (K1, K2): cp.async straight from the arena.
//  * CompressedTiles<F> (K5, K6; F = bf16 or fp16): the compressed arena
//    (int16 hub deltas, F distances, int8 levels: 5 bytes a cell instead
//    of 12), each lane loading its share with plain coalesced loads (4
//    cells a lane: 8 + 8 + 4 bytes a tile, where the lane is a multiple
//    of 4 and the arrays are aligned; a cell at a time otherwise),
//    decoded in registers and stored as int32, exactly as the
//    reference's `_decode_cells`: hub = tile_lo + delta where delta >=
//    0, else -1 (the pad flag); dist = min(float(x), DEV_INF) + 0.5
//    rounded to nearest, then truncated (`__float2int_rz`, as
//    `astype(int32)` truncates), so +inf pads decode to DEV_INF; wlev
//    widened. Built without fast math. Within a tile the deltas' order is
//    the hubs' order, so the merge check passes the compressed store's
//    tiles as it passes the int32 arena's.
// Everything after staging is one piece of code for both formats: the
// warp checks both tiles with one vote, and each lane binary-searches
// the t-tile for its s-cells (a stride of 32; each search starts where
// the lane's previous one ended) and walks the t-side run of each cell's
// hub (repeated hubs are Pareto entries); contiguous pieces a lane,
// walked forward as K7 walks, were slower for K2. The scalar kernel
// masks the staged distances in place at the item's level while it
// checks, keeps one running min in a register and ends in one warp_min
// and one global atomicMin. The profile kernel puts every meet into the
// warp's num_levels + 1 bins in shared memory by shared atomicMin, not
// into a per-thread array indexed by a run-time level (which would live
// in local memory), and writes its bins below DEV_INF with one global
// atomicMin each. The all-pairs bodies of earlier versions (a block an
// item, lane^2 compares, then block reductions of two barriers each)
// took 0.1727 ms (K1) and 0.2288 ms (K2) for the first flushes of the V
// = 2^17 run against bounds of 0.0195 and 0.0196 ms, and 0.0800 ms (K5)
// and 0.1136 ms (K6) of device time for the first flushes of the V =
// 2^15 compressed run against 0.00425 and 0.00430 ms (H100 80GB HBM3,
// 700 W).
//
// Bucket-pair (K7, K8), per query b of one planned sub-batch: the join of
// row srow[b] of the s-side tiles [Ns, Ws] with row trow[b] of the t-side
// tiles [Nt, Wt] (pads hub -1, dist INF_DIST, wlev -1). The Pallas kernel
// walks a (query, t-block) grid and accumulates across t-blocks;
// `_fit_block` exists only so that the block divides Wt.
//
// Gathered (K9), per query b of a [B, L] batch: the join of row b of
// hs/ds with row b of ht/dt, which `kernels/ops.py::gather_padded_rows`
// gathers from the padded store and masks (DEV_INF past the row's count
// and below the query's level). The Pallas kernel walks a (query block,
// t-block) grid and carries the min across t-blocks in its output block,
// which it initialises to DEV_INF; the wrapper pads B to 8 and L to 128.
// Here any B and L are taken as they are.
//
// K7, K8 and K9 share one row merge (`block_join`, templated on the row
// reader -- K7's and K8's rows carry wlev, K9's distances come masked --
// and on the join: `MinJoin`, one running min at the query's level, for
// K7 and K9; `BinJoin`, the profile's bins, for K8):
//  * a block (256 threads) per query. K7 and K8 answer a whole flush in
//    one launch: a block finds its query's sub-batch in a small device
//    table of SegGroup rows (tile pointers, Ws, Wt, its columns of the
//    staged [3, B] or [2, B] array), so no sub-batch is launched alone;
//    the per-sub-batch entry points are the same kernels over one group.
//  * Both rows are staged in shared memory with cp.async (16-byte copies
//    where the row is 16-byte aligned; at most SEG_STAGE = 2,048 cells a
//    side: 24 KB for three arrays, 16 KB for K9's two; a wider row is
//    read in place).
//  * The block checks both rows (above); a query whose rows fail is
//    joined all-pairs.
//  * Otherwise each thread takes one contiguous piece of the s-row's real
//    cells (at most ceil(Ws / 256) cells, whatever the meets), binary-
//    searches the t-row for the first cell with its first hub, and walks
//    forward (up to 8 steps, then a binary search again) pairing every
//    s-cell with the t-side run of its hub: O(Ws + Wt) steps plus the
//    meets, against Ws x Wt.
//  * K7 and K9 end in one block reduction and one store, no atomics. K8
//    puts every meet into the block's num_levels + 1 bins in shared
//    memory (shared atomicMin at the pair level) and writes its row of
//    the output from them (DEV_INF where a level has no meet).
// The all-pairs K9 of earlier versions compared L^2 cell pairs a query:
// 2.4728 ms at B = 4,096, L = 1,792 against a 0.0351 ms bound; the
// all-pairs K8 (a block per query, one launch per sub-batch, its level
// minima in a local array) 2.608 ms for the first profile flush in 24
// launches against 0.0258 ms (H100 80GB HBM3, 700 W).
//
// Every accumulator starts at DEV_INF, so no output exceeds it, and
// since distances lie in [0, DEV_INF] no sum overflows int32. The TPU's
// DMA ring has no counterpart in the ragged kernels.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DEV_INF (1 << 29)
#define MAX_LEVELS1 32     // most num_levels + 1 the profile kernels bin
#define SEG_THREADS 256    // K7 / K8 / K9: threads per query
#define SEG_STAGE 2048     // K7 / K8 / K9: widest row staged in shared memory
#define PROF_WARPS_MAX 8   // K1/K2/K5/K6: work items (warps) a block at most
#define PROF_SMEM 49152    // K1/K2/K5/K6: shared bytes a block uses at most

// --------------------------------------------------- compressed cells
// The reference's `_decode_cells`, one cell at a time: hub = tile_lo +
// delta where delta >= 0, else -1; dist clamped to DEV_INF, + 0.5 and
// truncated; wlev widened.
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename F>
__device__ __forceinline__ F from_bits(unsigned short b);
template <>
__device__ __forceinline__ __nv_bfloat16 from_bits<__nv_bfloat16>(
    unsigned short b) {
  return __ushort_as_bfloat16(b);
}
template <>
__device__ __forceinline__ __half from_bits<__half>(unsigned short b) {
  return __ushort_as_half(b);
}

__device__ __forceinline__ int decode_hub(int delta, int lo) {
  return delta >= 0 ? lo + delta : -1;
}

__device__ __forceinline__ int decode_dist(float x) {
  return __float2int_rz(__fadd_rn(fminf(x, (float)DEV_INF), 0.5f));
}

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

// ------------------------------------------------------------ staging
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
               "memory");
}

// Copy n cells of one array into shared memory (dst is 16-byte aligned),
// thread tid of nth: 16-byte copies where the source row is 16-byte
// aligned, else 4-byte.
__device__ __forceinline__ void stage_cells(int* dst, const int* src, int n,
                                            int tid, int nth) {
  if (((uintptr_t)src & 15) == 0) {
    const int n4 = n >> 2;
    for (int j = tid; j < n4; j += nth) cp_async16(dst + 4 * j, src + 4 * j);
    for (int j = 4 * n4 + tid; j < n; j += nth) cp_async4(dst + j, src + j);
  } else {
    for (int j = tid; j < n; j += nth) cp_async4(dst + j, src + j);
  }
}

// Shared-memory cells staged per array: n rounded up to 4 cells (16 bytes).
__host__ __device__ __forceinline__ int stage_cap(int n) {
  return (n + 3) / 4 * 4;
}

// First index in [lo, hi) whose hub is >= key (hi if none).
__device__ __forceinline__ int lower_bound(const int* hub, int lo, int hi,
                                           int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (hub[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// --------------------------------------------- ragged (K1, K2, K5, K6)
__device__ __forceinline__ bool tiles_meet(const int* tile_lo,
                                           const int* tile_hi, int s, int t) {
  return tile_lo[s] <= tile_hi[t] && tile_lo[t] <= tile_hi[s];
}

// K1 / K2 / K5 / K6: one warp per work item. A warp's slice of shared
// memory: the s-tile and the t-tile (hub, dist, wlev as int32; cap cells
// an array), then (profile) MAX_LEVELS1 bins.
__host__ __device__ __forceinline__ int query_warp_ints(int lane) {
  return 6 * stage_cap(lane);
}

__host__ __device__ __forceinline__ int prof_warp_ints(int lane) {
  return query_warp_ints(lane) + MAX_LEVELS1;
}

// Tile stagers: stage() fills a warp's slice (lane lid of 32) with one
// work item's two tiles s and t as int32 cells, the s-tile's hub, dist
// and wlev at sh, sh + cap and sh + 2 * cap, the t-tile's after them;
// after wait() and a __syncwarp every lane may read them.
//
// K1 / K2: the int32 arena, copied with cp.async.
struct Int32Tiles {
  const int* __restrict__ hub;
  const int* __restrict__ dist;
  const int* __restrict__ wlev;
  __device__ __forceinline__ void stage(int* sh, int cap, int s, int t,
                                        const int* tile_lo, int lane,
                                        int lid) const {
    const int64_t sb = (int64_t)s * lane, tb = (int64_t)t * lane;
    stage_cells(sh, hub + sb, lane, lid, 32);
    stage_cells(sh + cap, dist + sb, lane, lid, 32);
    stage_cells(sh + 2 * cap, wlev + sb, lane, lid, 32);
    stage_cells(sh + 3 * cap, hub + tb, lane, lid, 32);
    stage_cells(sh + 4 * cap, dist + tb, lane, lid, 32);
    stage_cells(sh + 5 * cap, wlev + tb, lane, lid, 32);
  }
  __device__ __forceinline__ void wait() const { cp_async_wait_all(); }
};

// K5 / K6: the compressed arena, loaded into registers, decoded and
// stored as int32. vec (set by the launcher): the lane is a multiple of
// 4 and the arrays are 8-, 8- and 4-byte aligned, so every tile is too
// and a lane loads 4 cells of a tile at once (8 bytes of hub deltas, 8
// of distances, 4 of levels); otherwise a cell at a time.
template <typename F>
struct CompressedTiles {
  const short* __restrict__ hub_delta;
  const F* __restrict__ dist;
  const signed char* __restrict__ wlev;
  int vec;

  // cells c..c+3 of one tile, packed as loaded (little-endian), into the
  // tile's three arrays at sh
  static __device__ __forceinline__ void store4(int* sh, int cap, int c,
                                                uint2 hd, uint2 d,
                                                unsigned w, int lo) {
    *(int4*)(sh + c) = make_int4(
        decode_hub((int)(short)(hd.x & 0xffffu), lo),
        decode_hub((int)hd.x >> 16, lo),
        decode_hub((int)(short)(hd.y & 0xffffu), lo),
        decode_hub((int)hd.y >> 16, lo));
    *(int4*)(sh + cap + c) = make_int4(
        decode_dist(to_f32(from_bits<F>(d.x & 0xffffu))),
        decode_dist(to_f32(from_bits<F>(d.x >> 16))),
        decode_dist(to_f32(from_bits<F>(d.y & 0xffffu))),
        decode_dist(to_f32(from_bits<F>(d.y >> 16))));
    *(int4*)(sh + 2 * cap + c) =
        make_int4((int)(w << 24) >> 24, (int)(w << 16) >> 24,
                  (int)(w << 8) >> 24, (int)w >> 24);
  }

  __device__ __forceinline__ void stage(int* sh, int cap, int s, int t,
                                        const int* tile_lo, int lane,
                                        int lid) const {
    const int64_t sb = (int64_t)s * lane, tb = (int64_t)t * lane;
    const int los = tile_lo[s], lot = tile_lo[t];
    int* st = sh + 3 * cap;
    if (vec) {
      for (int c = 4 * lid; c < lane; c += 128) {
        const uint2 hs = *(const uint2*)(hub_delta + sb + c);
        const uint2 ds = *(const uint2*)(dist + sb + c);
        const unsigned ws = *(const unsigned*)(wlev + sb + c);
        const uint2 ht = *(const uint2*)(hub_delta + tb + c);
        const uint2 dt = *(const uint2*)(dist + tb + c);
        const unsigned wt = *(const unsigned*)(wlev + tb + c);
        store4(sh, cap, c, hs, ds, ws, los);
        store4(st, cap, c, ht, dt, wt, lot);
      }
    } else {
      for (int c = lid; c < lane; c += 32) {
        sh[c] = decode_hub(hub_delta[sb + c], los);
        sh[cap + c] = decode_dist(to_f32(dist[sb + c]));
        sh[2 * cap + c] = wlev[sb + c];
        st[c] = decode_hub(hub_delta[tb + c], lot);
        st[cap + c] = decode_dist(to_f32(dist[tb + c]));
        st[2 * cap + c] = wlev[tb + c];
      }
    }
  }
  __device__ __forceinline__ void wait() const {}
};

// K2, K6: this lane's part of the merge check of one staged tile: real cells
// (hub >= 0) non-decreasing in hub, pads only after them, every pad inert
// (wlev < 0: its meets fall in no bin). Adds its real cells to *real.
__device__ __forceinline__ bool tile_mergeable(const int* hub,
                                               const int* wlev, int lane,
                                               int lid, int* real) {
  bool ok = true;
  for (int i = lid; i < lane; i += 32) {
    const int h = hub[i];
    if (h >= 0) {
      ++*real;
      if (i > 0) {
        const int p = hub[i - 1];
        ok &= p >= 0 && p <= h;
      }
    } else {
      ok &= wlev[i] < 0;
    }
  }
  return ok;
}

// K1, K5: the same check at the item's level w, which also masks this lane's
// staged distances in place (min(dist, DEV_INF) where wlev >= w, else
// DEV_INF); a pad is inert where its masked distance is DEV_INF.
__device__ __forceinline__ bool tile_mask_mergeable(const int* hub,
                                                    int* dist,
                                                    const int* wlev,
                                                    int lane, int lid, int w,
                                                    int* real) {
  bool ok = true;
  for (int i = lid; i < lane; i += 32) {
    const int d = wlev[i] >= w ? min(dist[i], DEV_INF) : DEV_INF;
    dist[i] = d;
    const int h = hub[i];
    if (h >= 0) {
      ++*real;
      if (i > 0) {
        const int p = hub[i - 1];
        ok &= p >= 0 && p <= h;
      }
    } else {
      ok &= d >= DEV_INF;
    }
  }
  return ok;
}

// K1 (Int32Tiles), K5 (CompressedTiles<F>)
template <typename Tiles>
__global__ void __launch_bounds__(32 * PROF_WARPS_MAX)
    wcsd_query_ragged_merge_kernel(
        Tiles tiles, const int* __restrict__ tile_lo,
        const int* __restrict__ tile_hi, const int* __restrict__ qidx,
        const int* __restrict__ stile, const int* __restrict__ ttile,
        const int* __restrict__ wq, int* __restrict__ out,
        long long worklist_len, int lane) {
  extern __shared__ __align__(16) int query_smem[];
  const int warp = threadIdx.x >> 5, lid = threadIdx.x & 31;
  const int cap = stage_cap(lane);
  int* sh = query_smem + warp * query_warp_ints(lane);
  int *s_hub = sh, *s_dist = sh + cap, *s_wlev = sh + 2 * cap;
  int *t_hub = sh + 3 * cap, *t_dist = sh + 4 * cap, *t_wlev = sh + 5 * cap;
  // every warp walks the worklist with the grid's stride (the grid is
  // what the card holds at once); all branches below are warp-uniform
  for (int64_t k = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
       k < worklist_len; k += (int64_t)gridDim.x * (blockDim.x >> 5)) {
    const int s = stile[k], t = ttile[k];
    if (!tiles_meet(tile_lo, tile_hi, s, t)) continue;
    const int q = qidx[k];
    const int w = wq[q];
    tiles.stage(sh, cap, s, t, tile_lo, lane, lid);
    tiles.wait();
    __syncwarp();
    int rs = 0, rt = 0;
    const bool ok =
        tile_mask_mergeable(s_hub, s_dist, s_wlev, lane, lid, w, &rs) &
        tile_mask_mergeable(t_hub, t_dist, t_wlev, lane, lid, w, &rt);
    const bool merge = __all_sync(0xffffffffu, ok);
    __syncwarp();  // every lane's masked distances are in place
    int best = DEV_INF;
    if (merge) {
      const int ns = __reduce_add_sync(0xffffffffu, rs);
      const int nt = __reduce_add_sync(0xffffffffu, rt);
      int j = 0;  // this lane's hubs rise, so each search starts at the last
      for (int i = lid; i < ns; i += 32) {
        const int ds = s_dist[i];
        if (ds >= DEV_INF) continue;  // its sums cannot go below DEV_INF
        const int h = s_hub[i];
        j = lower_bound(t_hub, j, nt, h);
        for (int jj = j; jj < nt && t_hub[jj] == h; ++jj)
          best = min(best, ds + t_dist[jj]);
      }
    } else {
      // tiles the merge cannot take: every cell pair, as the reference
      for (int i = lid; i < lane; i += 32) {
        const int h = s_hub[i], ds = s_dist[i];
        for (int jj = 0; jj < lane; ++jj)
          if (t_hub[jj] == h) best = min(best, ds + t_dist[jj]);
      }
    }
    best = warp_min(best);  // valid in lane 0
    if (lid == 0 && best < DEV_INF) atomicMin(out + q, best);
    __syncwarp();  // the next item rewrites the slice
  }
}

// K2 (Int32Tiles), K6 (CompressedTiles<F>)
template <typename Tiles>
__global__ void __launch_bounds__(32 * PROF_WARPS_MAX)
    wcsd_profile_ragged_merge_kernel(
        Tiles tiles, const int* __restrict__ tile_lo,
        const int* __restrict__ tile_hi, const int* __restrict__ qidx,
        const int* __restrict__ stile, const int* __restrict__ ttile,
        int* __restrict__ out, long long worklist_len, int lane,
        int levels1) {
  extern __shared__ __align__(16) int prof_smem[];
  const int warp = threadIdx.x >> 5, lid = threadIdx.x & 31;
  const int cap = stage_cap(lane);
  int* sh = prof_smem + warp * prof_warp_ints(lane);
  int *s_hub = sh, *s_dist = sh + cap, *s_wlev = sh + 2 * cap;
  int *t_hub = sh + 3 * cap, *t_dist = sh + 4 * cap, *t_wlev = sh + 5 * cap;
  int* bins = sh + 6 * cap;
  // every warp walks the worklist with the grid's stride (the grid is
  // what the card holds at once); all branches below are warp-uniform
  for (int64_t k = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
       k < worklist_len; k += (int64_t)gridDim.x * (blockDim.x >> 5)) {
    const int s = stile[k], t = ttile[k];
    if (!tiles_meet(tile_lo, tile_hi, s, t)) continue;
    const int q = qidx[k];
    tiles.stage(sh, cap, s, t, tile_lo, lane, lid);
    if (lid < levels1) bins[lid] = DEV_INF;
    tiles.wait();
    __syncwarp();
    int rs = 0, rt = 0;
    const bool ok = tile_mergeable(s_hub, s_wlev, lane, lid, &rs) &
                    tile_mergeable(t_hub, t_wlev, lane, lid, &rt);
    if (__all_sync(0xffffffffu, ok)) {
      const int ns = __reduce_add_sync(0xffffffffu, rs);
      const int nt = __reduce_add_sync(0xffffffffu, rt);
      int j = 0;  // this lane's hubs rise, so each search starts at the last
      for (int i = lid; i < ns; i += 32) {
        const int ws = s_wlev[i];
        if (ws < 0) continue;  // min(ws, wt) < 0: no bin
        const int h = s_hub[i];
        const int ds = min(s_dist[i], DEV_INF);
        j = lower_bound(t_hub, j, nt, h);
        for (int jj = j; jj < nt && t_hub[jj] == h; ++jj) {
          const int mw = min(ws, t_wlev[jj]);
          const int sum = ds + min(t_dist[jj], DEV_INF);
          if (mw >= 0 && mw < levels1 && sum < DEV_INF)
            atomicMin(bins + mw, sum);
        }
      }
    } else {
      // tiles the merge cannot take: every cell pair, as the reference
      for (int i = lid; i < lane; i += 32) {
        const int h = s_hub[i], ws = s_wlev[i];
        const int ds = min(s_dist[i], DEV_INF);
        for (int jj = 0; jj < lane; ++jj) {
          if (t_hub[jj] != h) continue;
          const int mw = min(ws, t_wlev[jj]);
          const int sum = ds + min(t_dist[jj], DEV_INF);
          if (mw >= 0 && mw < levels1 && sum < DEV_INF)
            atomicMin(bins + mw, sum);
        }
      }
    }
    __syncwarp();
    if (lid < levels1 && bins[lid] < DEV_INF)
      atomicMin(out + (int64_t)q * levels1 + lid, bins[lid]);
    __syncwarp();  // the next item rewrites the slice
  }
}

// ----------------------------------- row merge (K7, K8, K9), bucket-pair
// K7 and K8 answer a whole flush in one launch: a block per query, the
// query's sub-batch found in a small table of sub-batches (SegGroup). The
// per-sub-batch entry points are the same kernels over one group passed
// by value.
struct SegGroup {  // one planned sub-batch: 64 bytes, the host's row
  const int* hub_s;
  const int* dist_s;
  const int* wlev_s;
  const int* hub_t;
  const int* dist_t;
  const int* wlev_t;
  int Ws, Wt;  // row widths of the two tiles
  int off, n;  // the sub-batch's columns of the staged [3 or 2, B] array
};
static_assert(sizeof(SegGroup) == 64, "SegGroup is the host table's row");

// The sub-batch of query k: the last of the G groups starting at or
// before k, or `one` where there is no table (G == 0).
__device__ __forceinline__ SegGroup find_group(
    const SegGroup* __restrict__ groups, int G, const SegGroup& one, int k) {
  if (G == 0) return one;
  int lo = 0, hi = G - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (groups[mid].off <= k)
      lo = mid;
    else
      hi = mid - 1;
  }
  return groups[lo];
}

// One label row as the merge reads it: staged in shared memory, or (past
// the staging capacity) in place in global memory. K7's and K8's rows
// carry wlev (K7 masks by the query's level); K9's distances come masked.
struct SegRow {
  const int* hub;
  const int* dist;
  const int* wlev;
  int n;
  __device__ __forceinline__ int masked(int i, int w) const {
    return wlev[i] >= w ? min(dist[i], DEV_INF) : DEV_INF;
  }
};

struct GatheredRow {
  const int* hub;
  const int* dist;
  int n;
  __device__ __forceinline__ int masked(int i, int) const { return dist[i]; }
};

// Row [hub, dist, wlev] + base with width n: staged into smem (capacity
// cap cells an array) where n <= cap, else read in place.
__device__ __forceinline__ SegRow seg_row(const int* hub, const int* dist,
                                          const int* wlev, int64_t base,
                                          int n, int* smem, int cap) {
  if (n > cap) return SegRow{hub + base, dist + base, wlev + base, n};
  stage_cells(smem, hub + base, n, threadIdx.x, blockDim.x);
  stage_cells(smem + cap, dist + base, n, threadIdx.x, blockDim.x);
  stage_cells(smem + 2 * cap, wlev + base, n, threadIdx.x, blockDim.x);
  return SegRow{smem, smem + cap, smem + 2 * cap, n};
}

// The same for a gathered row [hub, dist] + base (two arrays).
__device__ __forceinline__ GatheredRow gathered_row(const int* hub,
                                                    const int* dist,
                                                    int64_t base, int n,
                                                    int* smem, int cap) {
  if (n > cap) return GatheredRow{hub + base, dist + base, n};
  stage_cells(smem, hub + base, n, threadIdx.x, blockDim.x);
  stage_cells(smem + cap, dist + base, n, threadIdx.x, blockDim.x);
  return GatheredRow{smem, smem + cap, n};
}

// What the row merge does at each hub meet, and which pads it may skip.
// cell(r, i) reads s-cell i once; live(c) says whether its meets can
// change anything; meet(c, rt, j) takes its meet with t-cell j.
//
// K7, K9: one running min at the query's level w; a pad is inert where
// its masked distance is DEV_INF (no pad meet reaches below DEV_INF).
struct MinJoin {
  int w;
  int best;
  template <typename Row>
  __device__ __forceinline__ bool pad_inert(const Row& r, int i) const {
    return r.masked(i, w) >= DEV_INF;
  }
  template <typename Row>
  __device__ __forceinline__ int cell(const Row& r, int i) const {
    return r.masked(i, w);
  }
  static __device__ __forceinline__ bool live(int ds) {
    return ds < DEV_INF;
  }
  template <typename Row>
  __device__ __forceinline__ void meet(int ds, const Row& rt, int j) {
    best = min(best, ds + rt.masked(j, w));
  }
};

// K8: every meet's sum into the block's bins (shared) by shared atomicMin
// at its pair level min(wlev_s, wlev_t), where that is in [0, levels1);
// a pad is inert where its wlev is < 0 (its meets fall in no bin).
struct BinJoin {
  int* bins;
  int levels1;
  __device__ __forceinline__ bool pad_inert(const SegRow& r, int i) const {
    return r.wlev[i] < 0;
  }
  __device__ __forceinline__ int2 cell(const SegRow& r, int i) const {
    return make_int2(r.wlev[i], min(r.dist[i], DEV_INF));
  }
  static __device__ __forceinline__ bool live(int2 c) {
    return c.x >= 0 && c.y < DEV_INF;
  }
  __device__ __forceinline__ void meet(int2 c, const SegRow& rt, int j) {
    const int mw = min(c.x, rt.wlev[j]);
    const int sum = c.y + min(rt.dist[j], DEV_INF);
    if (mw >= 0 && mw < levels1 && sum < DEV_INF) atomicMin(bins + mw, sum);
  }
};

// This thread's part of the merge-join check of one row: real cells
// (hub >= 0) non-decreasing in hub, pads (hub < 0) only after them, and
// every pad inert for the join. Adds this thread's real cells to *nreal.
template <typename Row, typename Join>
__device__ __forceinline__ bool row_mergeable(const Row& r, const Join& join,
                                              int* nreal) {
  bool ok = true;
  int real = 0;
  for (int i = threadIdx.x; i < r.n; i += blockDim.x) {
    const int h = r.hub[i];
    if (h >= 0) {
      ++real;
      if (i > 0) {
        const int p = r.hub[i - 1];
        ok &= p >= 0 && p <= h;
      }
    } else {
      ok &= join.pad_inert(r, i);
    }
  }
  if (real) atomicAdd(nreal, real);
  return ok;
}

// The join of one query's two rows (staged and visible to the block):
// the merge where both rows pass the check, else every cell pair; every
// meet goes to join.meet. nreal[2] is zeroed before the block's barrier.
template <typename Row, typename Join>
__device__ __forceinline__ void block_join(const Row& rs, const Row& rt,
                                           Join& join, int* nreal) {
  const bool ok = row_mergeable(rs, join, &nreal[0]) &
                  row_mergeable(rt, join, &nreal[1]);
  const bool merge = __syncthreads_and(ok);  // also orders the atomics
  if (merge) {
    // a contiguous piece of the s-row's real cells per thread; each
    // pairs every s-cell with the t-side run of its hub
    const int ns = nreal[0], nt = nreal[1];
    const int per = (ns + blockDim.x - 1) / blockDim.x;
    const int i1 = min(ns, (int)(threadIdx.x + 1) * per);
    int j = 0, prev = -1;
    for (int i = threadIdx.x * per; i < i1; ++i) {
      const int h = rs.hub[i];
      if (h != prev) {  // a few steps forward, else binary search
        int k = 0;
        while (k < 8 && j < nt && rt.hub[j] < h) ++j, ++k;
        if (k == 8) j = lower_bound(rt.hub, j, nt, h);
        prev = h;
      }
      const auto c = join.cell(rs, i);
      if (!Join::live(c)) continue;  // its meets change nothing
      for (int jj = j; jj < nt && rt.hub[jj] == h; ++jj) join.meet(c, rt, jj);
    }
  } else {
    // rows the merge cannot take: every cell pair, as the reference
    for (int i = threadIdx.x; i < rs.n; i += blockDim.x) {
      const int hs = rs.hub[i];
      const auto c = join.cell(rs, i);
      for (int jj = 0; jj < rt.n; ++jj)
        if (rt.hub[jj] == hs) join.meet(c, rt, jj);
    }
  }
}

__global__ void __launch_bounds__(SEG_THREADS) wcsd_query_segmented_kernel(
    const SegGroup* __restrict__ groups, int G, SegGroup one,
    const int* __restrict__ srow, const int* __restrict__ trow,
    const int* __restrict__ wq, int* __restrict__ out, int cap_s,
    int cap_t) {
  extern __shared__ __align__(16) int seg_smem[];  // s: 3 x cap_s, t: 3 x cap_t
  __shared__ int red[32];
  __shared__ int nreal[2];
  const int k = blockIdx.x;
  const SegGroup g = find_group(groups, G, one, k);
  const int w = wq[k];
  if (threadIdx.x < 2) nreal[threadIdx.x] = 0;
  const SegRow rs = seg_row(g.hub_s, g.dist_s, g.wlev_s,
                            (int64_t)srow[k] * g.Ws, g.Ws, seg_smem, cap_s);
  const SegRow rt = seg_row(g.hub_t, g.dist_t, g.wlev_t,
                            (int64_t)trow[k] * g.Wt, g.Wt,
                            seg_smem + 3 * cap_s, cap_t);
  cp_async_wait_all();
  __syncthreads();
  MinJoin join{w, DEV_INF};
  block_join(rs, rt, join, nreal);
  const int best = block_min(join.best, red);
  if (threadIdx.x == 0) out[k] = best;
}

__global__ void __launch_bounds__(SEG_THREADS) wcsd_profile_segmented_kernel(
    const SegGroup* __restrict__ groups, int G, SegGroup one,
    const int* __restrict__ srow, const int* __restrict__ trow,
    int* __restrict__ out, int cap_s, int cap_t, int levels1) {
  extern __shared__ __align__(16) int seg_smem[];  // s: 3 x cap_s, t: 3 x cap_t
  __shared__ int bins[MAX_LEVELS1];
  __shared__ int nreal[2];
  const int k = blockIdx.x;
  const SegGroup g = find_group(groups, G, one, k);
  if (threadIdx.x < 2) nreal[threadIdx.x] = 0;
  if (threadIdx.x < levels1) bins[threadIdx.x] = DEV_INF;
  const SegRow rs = seg_row(g.hub_s, g.dist_s, g.wlev_s,
                            (int64_t)srow[k] * g.Ws, g.Ws, seg_smem, cap_s);
  const SegRow rt = seg_row(g.hub_t, g.dist_t, g.wlev_t,
                            (int64_t)trow[k] * g.Wt, g.Wt,
                            seg_smem + 3 * cap_s, cap_t);
  cp_async_wait_all();
  __syncthreads();
  BinJoin join{bins, levels1};
  block_join(rs, rt, join, nreal);
  __syncthreads();  // every meet is in the bins
  if (threadIdx.x < levels1)
    out[(int64_t)k * levels1 + threadIdx.x] = bins[threadIdx.x];
}

// ------------------------------------------------------------ gathered (K9)
__global__ void __launch_bounds__(SEG_THREADS) wcsd_query_gathered_kernel(
    const int* __restrict__ hs, const int* __restrict__ ds,
    const int* __restrict__ ht, const int* __restrict__ dt,
    int* __restrict__ out, int L, int cap) {
  extern __shared__ __align__(16) int seg_smem[];  // s: 2 x cap, t: 2 x cap
  __shared__ int red[32];
  __shared__ int nreal[2];
  const int64_t base = (int64_t)blockIdx.x * L;
  if (threadIdx.x < 2) nreal[threadIdx.x] = 0;
  const GatheredRow rs = gathered_row(hs, ds, base, L, seg_smem, cap);
  const GatheredRow rt = gathered_row(ht, dt, base, L, seg_smem + 2 * cap,
                                      cap);
  cp_async_wait_all();
  __syncthreads();
  MinJoin join{0, DEV_INF};
  block_join(rs, rt, join, nreal);
  const int best = block_min(join.best, red);
  if (threadIdx.x == 0) out[blockIdx.x] = best;
}

// ------------------------------------------------------------- launchers
// The grid of a warp-per-item kernel (K1, K2, K5, K6) whose warps each
// use warp_bytes of shared memory: as many warps a block as PROF_SMEM
// holds (at most PROF_WARPS_MAX), as many blocks as the card holds at
// once (each warp walks the worklist), and no more than the items need.
template <typename Kernel>
static int warp_item_grid(Kernel kernel, size_t warp_bytes,
                          long long worklist_len, int* wpb,
                          long long* blocks) {
  if (warp_bytes > PROF_SMEM) return (int)cudaErrorInvalidValue;
  *wpb = (int)(PROF_SMEM / warp_bytes) < PROF_WARPS_MAX
             ? (int)(PROF_SMEM / warp_bytes)
             : PROF_WARPS_MAX;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, 32 * *wpb, *wpb * warp_bytes);
  if (err != cudaSuccess) return (int)err;
  *blocks = (worklist_len + *wpb - 1) / *wpb;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (*blocks > resident) *blocks = resident;
  return 0;
}

// K1 / K5: a warp per work item (the grid of warp_item_grid).
template <typename Tiles>
static int launch_query_ragged(Tiles tiles, const void* tile_lo,
                               const void* tile_hi, const void* qidx,
                               const void* stile, const void* ttile,
                               const void* wq, void* out,
                               long long worklist_len, int lane,
                               void* stream) {
  if (worklist_len <= 0) return 0;
  if (lane < 1) return (int)cudaErrorInvalidValue;
  const size_t warp_bytes = sizeof(int) * (size_t)query_warp_ints(lane);
  int wpb = 0;
  long long blocks = 0;
  const int err = warp_item_grid(wcsd_query_ragged_merge_kernel<Tiles>,
                                 warp_bytes, worklist_len, &wpb, &blocks);
  if (err) return err;
  wcsd_query_ragged_merge_kernel<Tiles><<<(unsigned)blocks, 32 * wpb,
                                          wpb * warp_bytes,
                                          (cudaStream_t)stream>>>(
      tiles, (const int*)tile_lo, (const int*)tile_hi, (const int*)qidx,
      (const int*)stile, (const int*)ttile, (const int*)wq, (int*)out,
      worklist_len, lane);
  return (int)cudaGetLastError();
}

// K2 / K6: a warp per work item (the grid of warp_item_grid).
template <typename Tiles>
static int launch_profile_ragged(Tiles tiles, const void* tile_lo,
                                 const void* tile_hi, const void* qidx,
                                 const void* stile, const void* ttile,
                                 void* out, long long worklist_len, int lane,
                                 int levels1, void* stream) {
  if (worklist_len <= 0) return 0;
  if (levels1 < 1 || levels1 > MAX_LEVELS1 || lane < 1)
    return (int)cudaErrorInvalidValue;
  const size_t warp_bytes = sizeof(int) * (size_t)prof_warp_ints(lane);
  int wpb = 0;
  long long blocks = 0;
  const int err = warp_item_grid(wcsd_profile_ragged_merge_kernel<Tiles>,
                                 warp_bytes, worklist_len, &wpb, &blocks);
  if (err) return err;
  wcsd_profile_ragged_merge_kernel<Tiles><<<(unsigned)blocks, 32 * wpb,
                                            wpb * warp_bytes,
                                            (cudaStream_t)stream>>>(
      tiles, (const int*)tile_lo, (const int*)tile_hi, (const int*)qidx,
      (const int*)stile, (const int*)ttile, (int*)out, worklist_len, lane,
      levels1);
  return (int)cudaGetLastError();
}

static Int32Tiles int32_tiles(const void* hub, const void* dist,
                              const void* wlev) {
  return Int32Tiles{(const int*)hub, (const int*)dist, (const int*)wlev};
}

template <typename F>
static CompressedTiles<F> compressed_tiles(const void* hub_delta,
                                           const void* dist,
                                           const void* wlev, int lane) {
  const int vec = lane % 4 == 0 && ((uintptr_t)hub_delta & 7) == 0 &&
                  ((uintptr_t)dist & 7) == 0 && ((uintptr_t)wlev & 3) == 0;
  return CompressedTiles<F>{(const short*)hub_delta, (const F*)dist,
                            (const signed char*)wlev, vec};
}

extern "C" int wcsd_query_ragged_launch(
    const void* hub, const void* dist, const void* wlev, const void* tile_lo,
    const void* tile_hi, const void* qidx, const void* stile,
    const void* ttile, const void* wq, void* out, long long worklist_len,
    int lane, void* stream) {
  return launch_query_ragged(int32_tiles(hub, dist, wlev), tile_lo, tile_hi,
                             qidx, stile, ttile, wq, out, worklist_len, lane,
                             stream);
}

extern "C" int wcsd_profile_ragged_launch(
    const void* hub, const void* dist, const void* wlev, const void* tile_lo,
    const void* tile_hi, const void* qidx, const void* stile,
    const void* ttile, void* out, long long worklist_len, int lane,
    int levels1, void* stream) {
  return launch_profile_ragged(int32_tiles(hub, dist, wlev), tile_lo,
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
        compressed_tiles<__half>(hub_delta, dist, wlev, lane), tile_lo,
        tile_hi, qidx, stile, ttile, wq, out, worklist_len, lane, stream);
  return launch_query_ragged(
      compressed_tiles<__nv_bfloat16>(hub_delta, dist, wlev, lane), tile_lo,
      tile_hi, qidx, stile, ttile, wq, out, worklist_len, lane, stream);
}

extern "C" int wcsd_profile_ragged_compressed_launch(
    const void* hub_delta, const void* dist, const void* wlev,
    const void* tile_lo, const void* tile_hi, const void* qidx,
    const void* stile, const void* ttile, void* out, long long worklist_len,
    int lane, int levels1, int dist_is_fp16, void* stream) {
  if (dist_is_fp16)
    return launch_profile_ragged(
        compressed_tiles<__half>(hub_delta, dist, wlev, lane), tile_lo,
        tile_hi, qidx, stile, ttile, out, worklist_len, lane, levels1,
        stream);
  return launch_profile_ragged(
      compressed_tiles<__nv_bfloat16>(hub_delta, dist, wlev, lane), tile_lo,
      tile_hi, qidx, stile, ttile, out, worklist_len, lane, levels1, stream);
}

// The checks of a bucket-pair launch (K7, K8), and the opt-in of its
// kernel to 6 x SEG_STAGE cells of dynamic shared memory (once per
// device: opted[dev]). Returns a cudaError_t.
template <typename Kernel>
static int seg_prepare(Kernel kernel, bool* opted, long long batch,
                       int cap_s, int cap_t) {
  if (batch > 0x7fffffffLL || cap_s < 0 || cap_t < 0 ||
      cap_s > SEG_STAGE || cap_t > SEG_STAGE)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 0 && dev < 16 && !opted[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(sizeof(int) * 6 * SEG_STAGE));
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  return 0;
}

static int launch_query_segmented(const SegGroup* groups, int G,
                                  SegGroup one, const void* srow,
                                  const void* trow, const void* wq,
                                  void* out, long long batch, int cap_s,
                                  int cap_t, void* stream) {
  if (batch <= 0) return 0;
  static bool opted[16];
  const int err = seg_prepare(wcsd_query_segmented_kernel, opted, batch,
                              cap_s, cap_t);
  if (err) return err;
  const size_t smem = sizeof(int) * 3 * ((size_t)cap_s + cap_t);
  wcsd_query_segmented_kernel<<<(unsigned)batch, SEG_THREADS, smem,
                                (cudaStream_t)stream>>>(
      groups, G, one, (const int*)srow, (const int*)trow, (const int*)wq,
      (int*)out, cap_s, cap_t);
  return (int)cudaGetLastError();
}

static int launch_profile_segmented(const SegGroup* groups, int G,
                                    SegGroup one, const void* srow,
                                    const void* trow, void* out,
                                    long long batch, int cap_s, int cap_t,
                                    int levels1, void* stream) {
  if (batch <= 0) return 0;
  if (levels1 < 1 || levels1 > MAX_LEVELS1) return (int)cudaErrorInvalidValue;
  static bool opted[16];
  const int err = seg_prepare(wcsd_profile_segmented_kernel, opted, batch,
                              cap_s, cap_t);
  if (err) return err;
  const size_t smem = sizeof(int) * 3 * ((size_t)cap_s + cap_t);
  wcsd_profile_segmented_kernel<<<(unsigned)batch, SEG_THREADS, smem,
                                  (cudaStream_t)stream>>>(
      groups, G, one, (const int*)srow, (const int*)trow, (int*)out, cap_s,
      cap_t, levels1);
  return (int)cudaGetLastError();
}

// One sub-batch as a group passed by value, with the staging capacities
// of its two widths (0 where a row is read in place).
static SegGroup one_group(const void* hub_s, const void* dist_s,
                          const void* wlev_s, const void* hub_t,
                          const void* dist_t, const void* wlev_t, int Ws,
                          int Wt, long long batch) {
  return SegGroup{(const int*)hub_s, (const int*)dist_s, (const int*)wlev_s,
                  (const int*)hub_t, (const int*)dist_t, (const int*)wlev_t,
                  Ws, Wt, 0, (int)batch};
}

static int stage_width(int W) { return stage_cap(W <= SEG_STAGE ? W : 0); }

extern "C" int wcsd_query_segmented_launch(
    const void* hub_s, const void* dist_s, const void* wlev_s,
    const void* hub_t, const void* dist_t, const void* wlev_t,
    const void* srow, const void* trow, const void* wq, void* out,
    long long batch, int Ws, int Wt, void* stream) {
  if (Ws < 1 || Wt < 1) return (int)cudaErrorInvalidValue;
  return launch_query_segmented(
      nullptr, 0,
      one_group(hub_s, dist_s, wlev_s, hub_t, dist_t, wlev_t, Ws, Wt, batch),
      srow, trow, wq, out, batch, stage_width(Ws), stage_width(Wt), stream);
}

// groups: G SegGroup rows in device memory, their [off, off + n) ranges
// tiling [0, batch) in order; widest_s / widest_t: the widest row of
// each side at most SEG_STAGE wide (0 if none).
extern "C" int wcsd_query_segmented_grouped_launch(
    const void* groups, int G, const void* srow, const void* trow,
    const void* wq, void* out, long long batch, int widest_s, int widest_t,
    void* stream) {
  if (G < 1) return batch > 0 ? (int)cudaErrorInvalidValue : 0;
  return launch_query_segmented((const SegGroup*)groups, G, SegGroup{},
                                srow, trow, wq, out, batch,
                                stage_cap(widest_s), stage_cap(widest_t),
                                stream);
}

extern "C" int wcsd_profile_segmented_launch(
    const void* hub_s, const void* dist_s, const void* wlev_s,
    const void* hub_t, const void* dist_t, const void* wlev_t,
    const void* srow, const void* trow, void* out, long long batch, int Ws,
    int Wt, int levels1, void* stream) {
  if (Ws < 1 || Wt < 1) return (int)cudaErrorInvalidValue;
  return launch_profile_segmented(
      nullptr, 0,
      one_group(hub_s, dist_s, wlev_s, hub_t, dist_t, wlev_t, Ws, Wt, batch),
      srow, trow, out, batch, stage_width(Ws), stage_width(Wt), levels1,
      stream);
}

// K8 over a whole profile flush: groups as for K7's grouped launch, their
// columns of the staged [2, B] array (s and t rows).
extern "C" int wcsd_profile_segmented_grouped_launch(
    const void* groups, int G, const void* srow, const void* trow, void* out,
    long long batch, int widest_s, int widest_t, int levels1, void* stream) {
  if (G < 1) return batch > 0 ? (int)cudaErrorInvalidValue : 0;
  return launch_profile_segmented((const SegGroup*)groups, G, SegGroup{},
                                  srow, trow, out, batch,
                                  stage_cap(widest_s), stage_cap(widest_t),
                                  levels1, stream);
}

// K9: a block per query; rows up to SEG_STAGE cells staged (hub + dist a
// side: at most 32 KB a block), wider rows read in place.
extern "C" int wcsd_query_gathered_launch(const void* hs, const void* ds,
                                          const void* ht, const void* dt,
                                          void* out, long long batch, int L,
                                          void* stream) {
  if (batch <= 0) return 0;
  if (L < 1 || batch > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int cap = L <= SEG_STAGE ? stage_cap(L) : 0;
  wcsd_query_gathered_kernel<<<(unsigned)batch, SEG_THREADS,
                               sizeof(int) * 4 * (size_t)cap,
                               (cudaStream_t)stream>>>(
      (const int*)hs, (const int*)ds, (const int*)ht, (const int*)dt,
      (int*)out, L, cap);
  return (int)cudaGetLastError();
}

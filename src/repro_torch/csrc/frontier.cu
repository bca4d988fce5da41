// Constrained-BFS rounds: the rank-batched construction rounds of the
// WC-Index build and the single-root relaxation.
//
// Replaces: src/repro/kernels/frontier.py:wc_prune_emit_batched (K3),
//           src/repro/kernels/frontier.py:wc_relax_batched (K4) and
//           src/repro/kernels/frontier.py:frontier_relax_gathered (K10).
//
// K3, per (root b, vertex v) with an active frontier level f = F[b, v]:
//   q = min_i min(dist[v,i], DEV_INF)
//             + min(T[b, min(hub[v,i], V - 1), f], DEV_INF)
//       over entries with hub >= 0 and wlev >= f (else INF_DIST);
//   emit[b, v] = f if q > d else -1  (-1 where F < 0).
// K4, per (b, v): cand = max_j min(emit[b, min(nbr[v,j], V - 1)],
//   lvl[v,j]) over the slots with nbr >= 0 (-1 at the others), kept only
//   where rank[v] > root_ranks[b]; newF = cand if cand > R else -1,
//   newR = max(R, cand).
//
// Pads may sit anywhere in a row. Every slot before the row's end is
// read and each pad is masked as a cell, as the reference does. The row
// end (row_end[v], one past the last slot that can contribute: hub >= 0
// and wlev >= 0 for K3, nbr >= 0 and lvl >= 0 for K4; any larger value
// is exact too) bounds the scan; a smaller one cuts the row, its later
// slots pads, as the plain versions read them too. The builder passes its own: the partial
// index's per-row counts, uploaded once per root batch, and the
// adjacency's, computed once per build; the wrappers compute it from the
// arrays where the caller gives none. A neighbour id >= V is read as
// V - 1, as the reference clips it (a pad_node = V pad is then masked by
// its level -1). K4 starts each maximum at -1, so a slot that gives
// <= -1 (a pad, an inactive emit) is skipped exactly: levels are >= -1
// and emit >= -1, as the builder makes them.
//
// What bounds them on the H100: bytes. Both do a handful of int ops per
// int32 they touch, and each round streams the [B, V] frontier arrays;
// the label / adjacency / table reads are gathers (the hub table T and
// one root's emit row are random-access by hub rank or neighbour id).
//
//  * K3 is one launch: a block owns 256 consecutive vertices, finds
//    their active roots, and pulls each active vertex's label row once
//    for all of them. Its bound is the frontier F read and emit written
//    once, each label row an active vertex needs read once, and the T
//    cells its feasible entries gather. The decision per cell is only
//    whether some feasible entry gives a distance <= d, so a root is
//    done at its first such entry.
//    1. A thread per vertex reads the vertex's B frontier cells
//       (coalesced along v). Inactive cells get emit -1 here, and the
//       active cells of a vertex with an empty row get f (nothing prunes
//       them); every other vertex with an active root goes on the block's
//       list in shared memory (one atomic per warp).
//    2. The block's warps take listed vertices in turn. A warp forms the
//       vertex's active-root mask with one ballot over F (a lane per
//       root) and reads the row once, up to its row end, in chunks of
//       128 entries staged in shared memory with 4-byte cp.async (two
//       buffers: the next chunk is in flight while this one is used; the
//       row's base need not be 16-byte aligned). Each chunk is applied to
//       every root still alive at the vertex, two roots at a time, a lane
//       per entry: lane i gathers T[b, f, hub] for entries i, i + 32, ...,
//       and one vote (__any_sync) tells whether some entry gave a
//       distance <= d; such a root is pruned and drops out, and the row
//       stops once no root is left. The per-root state is one warp-
//       uniform bit mask, so no per-root minima are kept anywhere.
//    T is level-major in memory ([B, W+1, V], the logical [B, V, W+1]
//    seen through its strides): a root's plane at one level is V words
//    (512 KB at V = 2^17), and along a hub-sorted row (the partial index
//    is appended in hub-rank order) the lanes' gathers fall on nearby,
//    often consecutive, words of that plane.
//    Tried and dropped (times on an H100 80GB HBM3 at 700 W, at the
//    build's heaviest pruning call: B = 32, V = 2^17, cap = 624, 1.67M
//    active cells):
//     - the first design, a thread per (b, v) in b-major order with the
//       warp sharing the scan of each active lane's row: it read each row
//       once per active root (~12.8 a vertex) 131,072 threads apart, out
//       of a 981 MB partial index L2 cannot hold, scanned every row to
//       its end, and gathered T at a 24-byte stride ([B, V, W+1]):
//       2.3477 ms;
//     - this design as two launches (a mask pass writing a global vertex
//       list after a memset, then persistent warps over the list): the
//       same kernel time over the build (0.757 s and its memsets
//       against 0.773 s, `torch.profiler`), 0.3754 ms at the heaviest
//       call, but a memset, a scratch tensor and a second launch a
//       call, ~21 us more of host time per call on the build's path
//       (2.21 s against 1.88 s of CUDA-event time over the build's
//       21,126 calls, one profiled run each);
//     - 64 registers (4 blocks an SM): 0.773 s of kernel time over the
//       build against 0.648 s at the kept 40 (6 blocks an SM); 64-entry
//       chunks (0.627 s) and 4 warps a block (0.657 s) were within 3%
//       and not kept (`torch.profiler`, one build each).
//  * K4 is a vertex-major pull behind a frontier bitmask, two launches:
//    1. Mask pass: act[w, v] (uint32) has bit b set where
//       emit[32w + b, v] >= 0; one thread per (w, v) reads its 32 emit
//       cells coalesced along v. At V = 2^17, B = 32 the mask is 512 KB
//       and stays in L2.
//    2. Relax pass: a block owns 128 consecutive vertices and up to 64
//       roots (two mask words). Per vertex it forms the eligible-root
//       mask elig from rank[v] > root_ranks[b] (root ranks in shared
//       memory); a vertex with elig == 0 reads no neighbour. Each row of
//       the padded adjacency is read once for all of the block's roots;
//       per neighbour n the kernel gathers act[w, n] (L2-resident) and
//       reads emit[b, n] only for the set bits of act & elig, keeping
//       per-root maxima in shared memory with integer atomicMax (exact,
//       order-free). Rows are walked by groups of 8 lanes (one vertex
//       each, slots 0..7, four vertices' loads in flight per group); a
//       row whose end is past slot 7 goes on a shared list and is
//       finished by a whole warp with its lanes along the row (coalesced,
//       four loads in flight per lane), so a hub row never holds one
//       thread for D serial steps.
//    Why not the first design (a thread per (b, v), b-major): it walked
//    each eligible row once per root with neighbouring threads D cells
//    apart and gathered emit[b, n] for every neighbour, although almost
//    every cell is -1 (~3,200 active (b, v) of 4.19M per round at
//    V = 2^17): 0.2342 ms at round 1 of the middle batch, 0.4993 ms per
//    call over the build. A push from the active cells with global
//    atomicMax was not taken: dense early rounds of the hub roots would
//    issue up to B * 2E ~ 33.5M atomics.
//  * The round d and the root ranks, scalar-prefetched on the TPU, are a
//    plain int argument and a device pointer.
//
// K10, per vertex v: cand = max_j min(fw_nbr[v,j], lvl[v,j]) over the
//   whole [V, D] row (the wrapper gathered Fw[nbr], -1 at pads);
//   newF = cand if cand > R else -1, newR = max(R, cand). It is K4 for
//   one root without the rank mask. The Pallas kernel tiles V into
//   [256, D] VMEM blocks and pads R with 1 << 20 to fill its grid; here
//   any V is taken and the last block masks its edge. Bound by bytes: two
//   int32 per cell, two operations. The padded adjacency of a BA graph is
//   almost all pads (D is the max degree, ~1,000 at V = 2^17, against a
//   mean of ~8), and K10 takes no row end, so every cell is read. One
//   warp owns a row and its lanes read consecutive cells (coalesced),
//   then max-reduce with shuffles. A thread per row, walking its D cells
//   alone with neighbouring threads D cells apart, measured slower on the
//   H100 at V = 2^17 and was not kept.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define DEV_INF (1 << 29)
#define INF_DIST (1 << 30)

#define FULL_MASK 0xffffffffu

static const int kThreads = 256;

// ------------------------------------------------------------ helpers
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------------ K3
#define PRUNE_WARPS 8                     // warps per block
#define PRUNE_THREADS (32 * PRUNE_WARPS)  // also vertices per block
#define PRUNE_PER_LANE 4                  // staged entries per lane
#define PRUNE_CHUNK (32 * PRUNE_PER_LANE)

// This lane's least distance for one root over its staged entries of a
// chunk (INF_DIST where none is feasible).
__device__ __forceinline__ int lane_min(const int* __restrict__ Tp,
                                        const int* h, const int* dd,
                                        const int* wl, int f, int V) {
  int q = INF_DIST;
#pragma unroll
  for (int k = 0; k < PRUNE_PER_LANE; ++k)
    if (h[k] >= 0 && wl[k] >= f)
      q = min(q, dd[k] + min(__ldg(Tp + min(h[k], V - 1)), DEV_INF));
  return q;
}

__global__ void __launch_bounds__(PRUNE_THREADS, 6) wc_prune_emit_kernel(
    const int* __restrict__ F, const int* __restrict__ T,
    const int* __restrict__ hub, const int* __restrict__ dist,
    const int* __restrict__ wlev, const int* __restrict__ row_end,
    int* __restrict__ emit, int B, int V, int W1, int cap, int d) {
  // [warp][buffer][hub, dist, wlev][entry]: 24 KB a block
  __shared__ int stage[PRUNE_WARPS][2][3][PRUNE_CHUNK];
  __shared__ int list[PRUNE_THREADS];  // the block's vertices to pull
  __shared__ int nlist, next;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) nlist = 0, next = 0;
  __syncthreads();

  // 1. a thread per vertex: F read coalesced along v; inactive cells, and
  //    the active cells of an empty row (nothing can prune them), are
  //    written here; a vertex with an active root and a row is listed
  {
    const int64_t v = (int64_t)blockIdx.x * PRUNE_THREADS + tid;
    bool any = false;
    if (v < V) {
      const int L = min(max(row_end[v], 0), cap);
#pragma unroll 8
      for (int b = 0; b < B; ++b) {
        const int64_t x = (int64_t)b * V + v;
        const int f = F[x];
        if (f >= 0 && L > 0)
          any = true;
        else
          emit[x] = (f >= 0 && INF_DIST > d) ? f : -1;
      }
    }
    const unsigned m = __ballot_sync(FULL_MASK, any);
    if (m) {
      const int leader = __ffs(m) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&nlist, __popc(m));
      base = __shfl_sync(FULL_MASK, base, leader);
      if (any) list[base + __popc(m & ((1u << lane) - 1))] = (int)v;
    }
  }
  __syncthreads();

  // 2. a warp per listed vertex, taken in turn
  const int n = nlist;
  const int words = (B + 31) >> 5;
  for (;;) {
    int i = 0;
    if (lane == 0) i = atomicAdd(&next, 1);
    i = __shfl_sync(FULL_MASK, i, 0);
    if (i >= n) break;  // warp-uniform
    const int v = list[i];
    const int L = min(max(row_end[v], 0), cap);
    const int64_t row = (int64_t)v * cap;
    for (int w = 0; w < words; ++w) {
      const int b = 32 * w + lane;
      const int64_t x = (int64_t)b * V + v;
      const int f = b < B ? F[x] : -1;
      const unsigned bits = __ballot_sync(FULL_MASK, f >= 0);
      if (!bits) continue;  // warp-uniform
      const int fw = min(f, W1 - 1);
      unsigned alive = INF_DIST > d ? bits : 0u;  // warp-uniform
      auto stage_chunk = [&](int c0, int buf) {
        int(*s)[PRUNE_CHUNK] = stage[warp][buf];
#pragma unroll
        for (int k = 0; k < PRUNE_PER_LANE; ++k) {
          const int e = c0 + 32 * k + lane;
          if (e < L) {
            cp_async4(&s[0][32 * k + lane], hub + row + e);
            cp_async4(&s[1][32 * k + lane], dist + row + e);
            cp_async4(&s[2][32 * k + lane], wlev + row + e);
          }
        }
        cp_async_commit();
      };
      stage_chunk(0, 0);
      int buf = 0;
      for (int c0 = 0; c0 < L && alive; c0 += PRUNE_CHUNK, buf ^= 1) {
        const bool more = c0 + PRUNE_CHUNK < L;
        if (more) {
          stage_chunk(c0 + PRUNE_CHUNK, buf ^ 1);
          cp_async_wait_one();
        } else {
          cp_async_wait_all();
        }
        __syncwarp();
        int h[PRUNE_PER_LANE], dd[PRUNE_PER_LANE], wl[PRUNE_PER_LANE];
        int(*s)[PRUNE_CHUNK] = stage[warp][buf];
#pragma unroll
        for (int k = 0; k < PRUNE_PER_LANE; ++k) {
          const bool ok = c0 + 32 * k + lane < L;
          h[k] = ok ? s[0][32 * k + lane] : -1;
          dd[k] = ok ? min(s[1][32 * k + lane], DEV_INF) : 0;
          wl[k] = ok ? s[2][32 * k + lane] : -1;
        }
        unsigned m = alive;
        while (m) {  // two roots at a time: eight gathers in flight a lane
          const int j0 = __ffs(m) - 1;
          m &= m - 1;
          const int j1 = m ? __ffs(m) - 1 : j0;
          m &= m - 1;
          const int f0 = __shfl_sync(FULL_MASK, fw, j0);
          const int f1 = __shfl_sync(FULL_MASK, fw, j1);
          const int q0 = lane_min(T + ((int64_t)(32 * w + j0) * W1 + f0) * V,
                                  h, dd, wl, f0, V);
          const int q1 = lane_min(T + ((int64_t)(32 * w + j1) * W1 + f1) * V,
                                  h, dd, wl, f1, V);
          if (__any_sync(FULL_MASK, q0 <= d)) alive &= ~(1u << j0);
          if (__any_sync(FULL_MASK, q1 <= d)) alive &= ~(1u << j1);
        }
        __syncwarp();  // every lane is done with buf before it is refilled
      }
      cp_async_wait_all();  // a chunk in flight when the last root fell
      __syncwarp();
      if ((bits >> lane) & 1) emit[x] = (alive >> lane) & 1 ? f : -1;
    }
  }
}

// ------------------------------------------------------------------ K4
#define RELAX_TV 128      // vertices per block of the relax pass
#define RELAX_THREADS 256
#define RELAX_GROUP 8     // lanes per vertex in the first pass over a row
#define RELAX_WORDS 2     // mask words (of 32 roots) per block

__global__ void wc_relax_mask_kernel(const int* __restrict__ emit,
                                     unsigned* __restrict__ act, int B,
                                     int V) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int words = (B + 31) >> 5;
  if (idx >= (int64_t)words * V) return;
  const int w = (int)(idx / V);
  const int64_t v = idx % V;
  const int nb = min(32, B - 32 * w);
  const int* e = emit + (int64_t)32 * w * V + v;
  unsigned bits = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b)
    if (b < nb) bits |= (unsigned)(e[(int64_t)b * V] >= 0) << b;
  act[idx] = bits;
}

// Relax one neighbour n (already clipped to [0, V - 1]; slot pos of
// vertex vl's row) for the block's roots: emit is read only where
// act[n] & elig has a bit.
__device__ __forceinline__ void relax_neighbour(
    const int* __restrict__ emit, const unsigned* __restrict__ act,
    const int* __restrict__ lvl, const unsigned* elig, int* cand, int n,
    int64_t pos, int vl, int w0, int words, int V) {
  int l = 0;
  bool have_l = false;
  for (int w = 0; w < words; ++w) {
    unsigned a = act[(int64_t)(w0 + w) * V + n] & elig[w * RELAX_TV + vl];
    if (!a) continue;
    if (!have_l) l = lvl[pos], have_l = true;
    const int* er = emit + (int64_t)32 * (w0 + w) * V + n;
    while (a) {
      const int b = __ffs(a) - 1;
      a &= a - 1;
      atomicMax(&cand[(32 * w + b) * RELAX_TV + vl],
                min(er[(int64_t)b * V], l));
    }
  }
}

__global__ void __launch_bounds__(RELAX_THREADS) wc_relax_pull_kernel(
    const int* __restrict__ emit, const unsigned* __restrict__ act,
    const int* __restrict__ nbr, const int* __restrict__ lvl,
    const int* __restrict__ rank, const int* __restrict__ root_ranks,
    const int* __restrict__ row_end, const int* __restrict__ R,
    int* __restrict__ newF, int* __restrict__ newR, int B, int V, int D) {
  extern __shared__ int relax_smem[];
  const int w0 = blockIdx.y * RELAX_WORDS;
  const int words = min(RELAX_WORDS, ((B + 31) >> 5) - w0);
  const int b0 = 32 * w0;
  const int nb = min(32 * words, B - b0);        // roots of this block
  int* cand = relax_smem;                         // [32 * words][TV]
  unsigned* elig = reinterpret_cast<unsigned*>(
      cand + 32 * words * RELAX_TV);              // [words][TV]
  int* rr = reinterpret_cast<int*>(elig + words * RELAX_TV);  // [32*words]
  int* rend = rr + 32 * words;                    // [TV] slots to read
  int* longv = rend + RELAX_TV;                   // [TV] rows past slot 7
  int* nlong = longv + RELAX_TV;
  const int tid = threadIdx.x;
  const int64_t v0 = (int64_t)blockIdx.x * RELAX_TV;

  for (int i = tid; i < 32 * words; i += RELAX_THREADS)
    rr[i] = i < nb ? root_ranks[b0 + i] : INT_MAX;   // pad bits never set
  for (int i = tid; i < 32 * words * RELAX_TV; i += RELAX_THREADS)
    cand[i] = -1;
  if (tid == 0) *nlong = 0;
  __syncthreads();
  if (tid < RELAX_TV) {
    const int rk = v0 + tid < V ? rank[v0 + tid] : INT_MIN;
    bool any = false;
    for (int w = 0; w < words; ++w) {
      unsigned m = 0;
      for (int b = 0; b < 32; ++b)
        m |= (unsigned)(rk > rr[32 * w + b]) << b;
      elig[w * RELAX_TV + tid] = m;
      any |= m != 0;
    }
    // a vertex no block root may label reads nothing (any implies v < V)
    const int L = any ? min(max(row_end[v0 + tid], 0), D) : 0;
    rend[tid] = L;
    if (L > RELAX_GROUP) longv[atomicAdd(nlong, 1)] = tid;
  }
  __syncthreads();

  // slots 0..7 of every row: a group of 8 lanes per vertex, the loads of
  // its four vertices in flight together
  {
    static_assert(RELAX_TV == 4 * (RELAX_THREADS / RELAX_GROUP),
                  "a group owns four vertices");
    const int gi = tid / RELAX_GROUP, gl = tid % RELAX_GROUP;
    constexpr int kStride = RELAX_THREADS / RELAX_GROUP;
    auto slot = [&](int vl) {
      return gl < rend[vl] ? nbr[(v0 + vl) * (int64_t)D + gl] : -1;
    };
    auto visit = [&](int vl, int n) {
      if (n < 0) return;  // a pad, wherever it sits
      relax_neighbour(emit, act, lvl, elig, cand, min(n, V - 1),
                      (v0 + vl) * (int64_t)D + gl, vl, w0, words, V);
    };
    const int na = slot(gi), nb_ = slot(gi + kStride),
              nc = slot(gi + 2 * kStride), nd = slot(gi + 3 * kStride);
    visit(gi, na);
    visit(gi + kStride, nb_);
    visit(gi + 2 * kStride, nc);
    visit(gi + 3 * kStride, nd);
  }
  __syncthreads();

  // the rest of the long rows, up to their row end: a warp per row,
  // lanes along it, every pad masked
  {
    const int warp = tid >> 5, lane = tid & 31;
    const int nl = *nlong;
    for (int li = warp; li < nl; li += RELAX_THREADS / 32) {
      const int vl = longv[li];
      const int L = rend[vl];
      const int64_t row = (v0 + vl) * (int64_t)D;
      for (int j0 = RELAX_GROUP; j0 < L; j0 += 128) {  // 4 loads a lane
        const int j = j0 + lane;
        const int na = j < L ? nbr[row + j] : -1;
        const int nb_ = j + 32 < L ? nbr[row + j + 32] : -1;
        const int nc = j + 64 < L ? nbr[row + j + 64] : -1;
        const int nd = j + 96 < L ? nbr[row + j + 96] : -1;
        if (na >= 0)
          relax_neighbour(emit, act, lvl, elig, cand, min(na, V - 1),
                          row + j, vl, w0, words, V);
        if (nb_ >= 0)
          relax_neighbour(emit, act, lvl, elig, cand, min(nb_, V - 1),
                          row + j + 32, vl, w0, words, V);
        if (nc >= 0)
          relax_neighbour(emit, act, lvl, elig, cand, min(nc, V - 1),
                          row + j + 64, vl, w0, words, V);
        if (nd >= 0)
          relax_neighbour(emit, act, lvl, elig, cand, min(nd, V - 1),
                          row + j + 96, vl, w0, words, V);
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < nb * RELAX_TV; i += RELAX_THREADS) {
    const int bl = i / RELAX_TV, vl = i % RELAX_TV;
    const int64_t v = v0 + vl;
    if (v >= V) continue;
    const int64_t idx = (int64_t)(b0 + bl) * V + v;
    const int c = cand[bl * RELAX_TV + vl], r = R[idx];
    newF[idx] = c > r ? c : -1;
    newR[idx] = max(r, c);
  }
}

// ----------------------------------------------------------------- K10
__global__ void frontier_relax_gathered_kernel(
    const int* __restrict__ fw_nbr, const int* __restrict__ lvl,
    const int* __restrict__ R, int* __restrict__ newF,
    int* __restrict__ newR, int V, int D) {
  const int64_t v =
      (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (v >= V) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int64_t row = v * (int64_t)D;
  int cand = INT_MIN;
  for (int j = lane; j < D; j += 32)
    cand = max(cand, min(fw_nbr[row + j], lvl[row + j]));
  for (int off = 16; off > 0; off >>= 1)
    cand = max(cand, __shfl_xor_sync(FULL_MASK, cand, off));
  if (lane == 0) {
    const int r = R[v];
    newF[v] = cand > r ? cand : -1;
    newR[v] = max(r, cand);
  }
}

// ------------------------------------------------------------ launchers
// T: the level-major table, [B][W1][V] in memory. row_end: [V].
extern "C" int wc_prune_emit_launch(const void* F, const void* T,
                                    const void* hub, const void* dist,
                                    const void* wlev, const void* row_end,
                                    void* emit, int B, int V, int W1,
                                    int cap, int d, void* stream) {
  if ((int64_t)B * V <= 0) return 0;
  wc_prune_emit_kernel<<<(unsigned)((V + PRUNE_THREADS - 1) /
                                    PRUNE_THREADS),
                         PRUNE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)F, (const int*)T, (const int*)hub, (const int*)dist,
      (const int*)wlev, (const int*)row_end, (int*)emit, B, V, W1, cap, d);
  return (int)cudaGetLastError();
}

// act: uint32 scratch of ceil(B / 32) * V words, allocated by the caller.
extern "C" int wc_relax_batched_launch(const void* emit, const void* nbr,
                                       const void* lvl, const void* rank,
                                       const void* root_ranks,
                                       const void* row_end, const void* R,
                                       void* newF, void* newR, void* act,
                                       int B, int V, int D, void* stream) {
  if (B <= 0 || V <= 0) return 0;
  const int words = (B + 31) / 32;
  const int64_t cells = (int64_t)words * V;
  cudaStream_t st = (cudaStream_t)stream;
  wc_relax_mask_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads),
                         kThreads, 0, st>>>((const int*)emit,
                                            (unsigned*)act, B, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per = min(words, RELAX_WORDS);
  const size_t smem = sizeof(int) * ((size_t)32 * per * RELAX_TV +
                                     (size_t)per * RELAX_TV + 32 * per +
                                     2 * RELAX_TV + 1);
  const dim3 grid((unsigned)((V + RELAX_TV - 1) / RELAX_TV),
                  (unsigned)((words + RELAX_WORDS - 1) / RELAX_WORDS));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  wc_relax_pull_kernel<<<grid, RELAX_THREADS, smem, st>>>(
      (const int*)emit, (const unsigned*)act, (const int*)nbr,
      (const int*)lvl, (const int*)rank, (const int*)root_ranks,
      (const int*)row_end, (const int*)R, (int*)newF, (int*)newR, B, V, D);
  return (int)cudaGetLastError();
}

extern "C" int frontier_relax_gathered_launch(const void* fw_nbr,
                                              const void* lvl, const void* R,
                                              void* newF, void* newR, int V,
                                              int D, void* stream) {
  if (V <= 0) return 0;
  if (D < 1) return (int)cudaErrorInvalidValue;
  const int rows_per_block = kThreads / 32;
  const unsigned blocks = (unsigned)((V + rows_per_block - 1) /
                                     rows_per_block);
  frontier_relax_gathered_kernel<<<blocks, kThreads, 0,
                                   (cudaStream_t)stream>>>(
      (const int*)fw_nbr, (const int*)lvl, (const int*)R, (int*)newF,
      (int*)newR, V, D);
  return (int)cudaGetLastError();
}

// Constrained-BFS rounds: the rank-batched construction rounds of the
// WC-Index build and the single-root relaxation.
//
// Replaces: src/repro/kernels/frontier.py:wc_prune_emit_batched (K3),
//           src/repro/kernels/frontier.py:wc_relax_batched (K4) and
//           src/repro/kernels/frontier.py:frontier_relax_gathered (K10).
//
// K3, per (root b, vertex v) with an active frontier level f = F[b, v]:
//   q = min_i min(dist[v,i], DEV_INF) + min(T[b, hub[v,i], f], DEV_INF)
//       over entries with hub >= 0 and wlev >= f (else INF_DIST);
//   emit[b, v] = f if q > d else -1  (-1 where F < 0).
// K4, per (b, v): cand = max_j min(emit[b, nbr[v,j]], lvl[v,j]), -1 for
//   pad neighbours, kept only where rank[v] > root_ranks[b];
//   newF = cand if cand > R else -1, newR = max(R, cand).
//
// What bounds them on the H100: bytes. Both do a handful of int ops per
// int32 they touch, and each round streams the [B, V] frontier arrays;
// the label / adjacency / table reads are gathers (the hub table T and
// one root's emit row are random-access by hub rank or neighbour id).
//
// Design: K3 runs one thread per (b, v) with no shared memory, a warp
// sharing the scan of each active row; K4 is a vertex-major pull.
//  * K3: on the TPU the whole table block T[b] ([V, W+1]) sits in VMEM;
//    at V = 2^17 that is 3 MB, more than a block's 227 KB of shared
//    memory, so T is gathered from global memory, where the touched
//    cells hit in the 50 MB L2. An inactive (b, v) (F < 0, most of them)
//    writes -1 without reading any labels. The few active lanes of a
//    warp are then taken one at a time, and the whole warp scans that
//    lane's label row with coalesced loads (lane i reads entries i,
//    i + 32, ...) and min-reduces with shuffles: a late-build row holds
//    thousands of entries, and one thread walking it alone is a chain of
//    dependent L2 round trips. A row is scanned up to its first pad
//    (hub < 0): the partial index is filled row-prefix first, so pads
//    sit at the tail and contribute only INF_DIST.
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
//       row whose slot 7 is real goes on a shared list and is finished
//       by a whole warp with its lanes along the row (coalesced, four
//       loads in flight per lane), so a hub row never holds one thread
//       for D serial steps. R is read and newF/newR written through the
//       shared tile, coalesced along v. A row is scanned only up to its
//       first pad (row-prefix fill); a neighbour whose emit is < 0
//       contributes min(emit, lvl) <= -1, which the -1 start already
//       covers, so skipping it is exact.
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
//   mean of ~8), and the contract does not promise row-prefix fill, so
//   every cell is read. One warp owns a row and its lanes read
//   consecutive cells (coalesced), then max-reduce with shuffles. A
//   thread per row, walking its D cells alone with neighbouring threads
//   D cells apart, measured slower on the H100 at V = 2^17 and was not
//   kept (the opposite of K4, whose rows end at their first pad).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define DEV_INF (1 << 29)
#define INF_DIST (1 << 30)

#define FULL_MASK 0xffffffffu

__global__ void wc_prune_emit_kernel(
    const int* __restrict__ F, const int* __restrict__ T,
    const int* __restrict__ hub, const int* __restrict__ dist,
    const int* __restrict__ wlev, int* __restrict__ emit, int B, int V,
    int W1, int cap, int d) {
  // no early return: every lane of the warp takes part in the shuffles
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = idx < (int64_t)B * V;
  const int f = valid ? F[idx] : -1;
  const int lane = threadIdx.x & 31;
  int my_q = INF_DIST;
  unsigned todo = __ballot_sync(FULL_MASK, f >= 0);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int64_t sidx = __shfl_sync(FULL_MASK, idx, src);
    const int fw = min(__shfl_sync(FULL_MASK, f, src), W1 - 1);
    const int64_t b = sidx / V, v = sidx % V;
    const int* Tb = T + b * (int64_t)V * W1;
    const int64_t row = v * (int64_t)cap;
    int q = INF_DIST;
    for (int i = lane; i < cap; i += 32) {
      const int h = hub[row + i];
      if (h < 0) break;  // row-prefix fill: the rest are pads
      if (wlev[row + i] < fw) continue;
      const int tv = Tb[(int64_t)h * W1 + fw];
      q = min(q, min(dist[row + i], DEV_INF) + min(tv, DEV_INF));
    }
    for (int off = 16; off > 0; off >>= 1)
      q = min(q, __shfl_xor_sync(FULL_MASK, q, off));
    if (lane == src) my_q = q;
  }
  if (valid) emit[idx] = (f >= 0 && my_q > d) ? f : -1;
}

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

// Relax one real neighbour n (slot pos of vertex vl's row) for the
// block's roots: emit is read only where act[n] & elig has a bit.
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
    const int* __restrict__ R, int* __restrict__ newF,
    int* __restrict__ newR, int B, int V, int D) {
  extern __shared__ int relax_smem[];
  const int w0 = blockIdx.y * RELAX_WORDS;
  const int words = min(RELAX_WORDS, ((B + 31) >> 5) - w0);
  const int b0 = 32 * w0;
  const int nb = min(32 * words, B - b0);        // roots of this block
  int* cand = relax_smem;                         // [32 * words][TV]
  unsigned* elig = reinterpret_cast<unsigned*>(
      cand + 32 * words * RELAX_TV);              // [words][TV]
  int* rr = reinterpret_cast<int*>(elig + words * RELAX_TV);  // [32*words]
  int* longv = rr + 32 * words;                   // [TV] rows past slot 7
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
    for (int w = 0; w < words; ++w) {
      unsigned m = 0;
      for (int b = 0; b < 32; ++b)
        m |= (unsigned)(rk > rr[32 * w + b]) << b;
      elig[w * RELAX_TV + tid] = m;
    }
  }
  __syncthreads();

  // slots 0..7 of every eligible row: a group of 8 lanes per vertex, the
  // loads of its four vertices issued together
  {
    static_assert(RELAX_TV == 4 * (RELAX_THREADS / RELAX_GROUP),
                  "a group owns four vertices");
    const int gi = tid / RELAX_GROUP, gl = tid % RELAX_GROUP;
    constexpr int kStride = RELAX_THREADS / RELAX_GROUP;
    auto slot = [&](int vl) {
      bool any = false;
      for (int w = 0; w < words; ++w) any |= elig[w * RELAX_TV + vl] != 0;
      return any && gl < D ? nbr[(v0 + vl) * (int64_t)D + gl] : -1;
    };
    auto visit = [&](int vl, int n) {
      if (n < 0) return;
      relax_neighbour(emit, act, lvl, elig, cand, n,
                      (v0 + vl) * (int64_t)D + gl, vl, w0, words, V);
      if (gl == RELAX_GROUP - 1 && D > RELAX_GROUP)
        longv[atomicAdd(nlong, 1)] = vl;
    };
    const int na = slot(gi), nb_ = slot(gi + kStride),
              nc = slot(gi + 2 * kStride), nd = slot(gi + 3 * kStride);
    visit(gi, na);
    visit(gi + kStride, nb_);
    visit(gi + 2 * kStride, nc);
    visit(gi + 3 * kStride, nd);
  }
  __syncthreads();

  // the rest of the long rows: a warp per row, lanes along it
  {
    const int warp = tid >> 5, lane = tid & 31;
    const int nl = *nlong;
    for (int li = warp; li < nl; li += RELAX_THREADS / 32) {
      const int vl = longv[li];
      const int64_t row = (v0 + vl) * (int64_t)D;
      for (int j0 = RELAX_GROUP; j0 < D; j0 += 128) {  // 4 loads a lane
        const int j = j0 + lane;
        const int na = j < D ? nbr[row + j] : -1;
        const int nb_ = j + 32 < D ? nbr[row + j + 32] : -1;
        const int nc = j + 64 < D ? nbr[row + j + 64] : -1;
        const int nd = j + 96 < D ? nbr[row + j + 96] : -1;
        const bool pad = (na | nb_ | nc | nd) < 0;
        if (na >= 0)
          relax_neighbour(emit, act, lvl, elig, cand, na, row + j, vl, w0,
                          words, V);
        if (nb_ >= 0)
          relax_neighbour(emit, act, lvl, elig, cand, nb_, row + j + 32, vl,
                          w0, words, V);
        if (nc >= 0)
          relax_neighbour(emit, act, lvl, elig, cand, nc, row + j + 64, vl,
                          w0, words, V);
        if (nd >= 0)
          relax_neighbour(emit, act, lvl, elig, cand, nd, row + j + 96, vl,
                          w0, words, V);
        if (__any_sync(FULL_MASK, pad)) break;  // row-prefix fill: done
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

static const int kThreads = 256;

extern "C" int wc_prune_emit_launch(const void* F, const void* T,
                                    const void* hub, const void* dist,
                                    const void* wlev, void* emit, int B,
                                    int V, int W1, int cap, int d,
                                    void* stream) {
  const int64_t n = (int64_t)B * V;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  wc_prune_emit_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)F, (const int*)T, (const int*)hub, (const int*)dist,
      (const int*)wlev, (int*)emit, B, V, W1, cap, d);
  return (int)cudaGetLastError();
}

// act: uint32 scratch of ceil(B / 32) * V words, allocated by the caller.
extern "C" int wc_relax_batched_launch(const void* emit, const void* nbr,
                                       const void* lvl, const void* rank,
                                       const void* root_ranks, const void* R,
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
                                     RELAX_TV + 1);
  const dim3 grid((unsigned)((V + RELAX_TV - 1) / RELAX_TV),
                  (unsigned)((words + RELAX_WORDS - 1) / RELAX_WORDS));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  wc_relax_pull_kernel<<<grid, RELAX_THREADS, smem, st>>>(
      (const int*)emit, (const unsigned*)act, (const int*)nbr,
      (const int*)lvl, (const int*)rank, (const int*)root_ranks,
      (const int*)R, (int*)newF, (int*)newR, B, V, D);
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

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
// Design: one thread per (b, v), no shared memory; in K3 a warp shares
// the scan of each active row.
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
//  * K4: a vertex that does not outrank the root writes cand = -1
//    without touching its neighbours. A row of the padded adjacency
//    (filled row-prefix first) is scanned only up to its first pad
//    neighbour, since pads contribute only -1, which keeps a BA graph's
//    max degree D (~sqrt V) from setting the cost of every row. Each
//    thread walks its own row: the hubs with long rows outrank almost
//    every root, so they are rarely scanned (a warp-shared scan of rows
//    over 32 neighbours measured slower on the H100 at V = 2^17).
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

__global__ void wc_relax_batched_kernel(
    const int* __restrict__ emit, const int* __restrict__ nbr,
    const int* __restrict__ lvl, const int* __restrict__ rank,
    const int* __restrict__ root_ranks, const int* __restrict__ R,
    int* __restrict__ newF, int* __restrict__ newR, int B, int V, int D) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)B * V) return;
  const int64_t b = idx / V, v = idx % V;
  int cand = -1;
  if (rank[v] > root_ranks[b]) {
    const int* er = emit + b * (int64_t)V;
    const int64_t row = v * (int64_t)D;
    for (int j = 0; j < D; ++j) {
      const int n = nbr[row + j];
      if (n < 0) break;  // row-prefix fill: the rest are pads
      cand = max(cand, min(er[n], lvl[row + j]));
    }
  }
  const int r = R[idx];
  newF[idx] = cand > r ? cand : -1;
  newR[idx] = max(r, cand);
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

extern "C" int wc_relax_batched_launch(const void* emit, const void* nbr,
                                       const void* lvl, const void* rank,
                                       const void* root_ranks, const void* R,
                                       void* newF, void* newR, int B, int V,
                                       int D, void* stream) {
  const int64_t n = (int64_t)B * V;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  wc_relax_batched_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)emit, (const int*)nbr, (const int*)lvl, (const int*)rank,
      (const int*)root_ranks, (const int*)R, (int*)newF, (int*)newR, B, V,
      D);
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

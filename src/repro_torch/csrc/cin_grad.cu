// xDeepFM CIN layer, weight gradient (K12).
//
// Replaces: no TPU kernel. The reference trains through the jnp scan
// `_cin` (src/repro/models/xdeepfm.py:133) and lets XLA differentiate it;
// its Pallas K11 (src/repro/kernels/cin_fuse.py:39) has no backward. The
// port's forward is K11 on the card, so its gradient runs on the card
// too: the two input gradients are K11 itself (`ops.CinLayer`), and the
// weight gradient is this kernel.
//
//   dw[k, h, m] = sum_{b, d} g[b, k, d] * x1[b, h, d] * x0[b, m, d]
//
// g [B, K, D], x1 [B, H, D], x0 [B, M, D] float32 in; dw [K, H, M]
// float32 out. As a GEMM:
//   C[k, r] = sum_n G[n, k] * Z[n, r],  n = b*D + d,  r = h*M + m,
//   G[n, k] = g[b, k, d],  Z[n, r] = x1[b, h, d] * x0[b, m, d],
// with Z formed in shared memory stage by stage, never in global memory.
//
// What bounds it on the H100: operations. 2*K*H*M*B*D FLOP on
// B*(K + H + M)*D + K*H*M values: at train_batch (B = 65,536) and the
// model's widths (K = H = 200, M = 39, D = 10) 2.04e12 FLOP on 0.5 GB,
// ~4,000 FLOP per byte; 30.5 ms at the 67 TFLOP/s of fp32 outside the
// tensor cores. 3xTF32 on wgmma (K11's arithmetic) is later work.
//
// Design (SIMT fp32):
//  * A block owns a 200 (k) x 80 (r) tile of C: 250 of its 256 threads
//    each hold 8 k x 8 r in registers (25 x 10 threads), so K = 200 is
//    one tile row with nothing wasted, and R = 7,800 is 97.5 tiles.
//  * The contraction is walked 16 n a stage. A stage's G [16 x 200], x0
//    [16 x M] and the x1 channels of the tile's h range are copied into
//    shared memory with cp.async, n the fastest index (coalesced: n =
//    b*D + d runs along d), double-buffered: the next stage's copies fly
//    while this stage's Z [16 x 80] is formed from the staged x1 and x0
//    and the threads do their 16 rank-1 updates (per n two 16-byte loads
//    of G and two of Z for 64 FMAs).
//  * The contraction (655,360 long at train_batch, against an output of
//    only 200 x 7,800) is cut into S slices of `rows` n (grid z); each
//    block writes its partial tile to its workspace slice, and a second
//    launch adds the S slices in index order (K11's split-sum pattern).
//    No float atomics: two launches on the same inputs are bit-identical.
// Measured on the H100 and replaced: a 64 (k) x 128 (r) tile of 4 x 8 a
// thread, staged through registers with four barriers a stage (197 ms at
// layers 1-2, 10.4 TFLOP/s; K = 200 in four 64-row tiles).
#include <cuda_runtime.h>
#include <stdint.h>

#define CG_TM 8                      // k per thread
#define CG_TN 8                      // r per thread
#define CG_TY 25                     // threads along k
#define CG_TX 10                     // threads along r
#define CG_BM (CG_TY * CG_TM)        // 200 k per block
#define CG_BN (CG_TX * CG_TN)        // 80 r per block
#define CG_BK 16                     // n per stage
#define CG_THREADS 256               // 250 compute; all copy and form Z
#define CG_GLD (CG_BM + 4)           // G stage row stride (words)

// odd row strides keep the n-fastest staging writes off shared bank
// conflicts
static __host__ __device__ inline int odd(int x) { return x | 1; }

// most distinct h among CG_BN consecutive r
static __host__ __device__ inline int cg_hs(int H, int M) {
  const int h = (CG_BN - 1) / M + 2;
  return h < H ? h : H;
}

// shared words of a block: G stages [2][BK][GLD], Z [BK][BN], x0 stages
// [2][BK][odd M], x1 stages [2][BK][odd hs]
static __host__ __device__ inline int cg_smem_words(int H, int M) {
  return 2 * CG_BK * CG_GLD + CG_BK * CG_BN +
         2 * CG_BK * (odd(M) + odd(cg_hs(H, M)));
}

// one 4-byte copy global -> shared, zero-filled where !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(CG_THREADS, 2)
    cin_weight_grad_kernel(const float* __restrict__ g,
                           const float* __restrict__ x1,
                           const float* __restrict__ x0,
                           float* __restrict__ out, int B, int H, int M,
                           int D, int K, int64_t rows) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int col_h[CG_BN], col_m[CG_BN];  // h - h0 (-1 past R), m
  const int ld0 = odd(M), ld1 = odd(cg_hs(H, M));
  float* gs = smem;                            // [2][BK][GLD]
  float* zs = gs + 2 * CG_BK * CG_GLD;         // [BK][BN]
  float* x0s = zs + CG_BK * CG_BN;             // [2][BK][ld0]
  float* x1s = x0s + 2 * CG_BK * ld0;          // [2][BK][ld1]

  const int tid = threadIdx.x;
  const int ty = tid / CG_TX, tx = tid % CG_TX;
  const int R = H * M;
  const int64_t N = (int64_t)B * D;
  const int k0 = blockIdx.y * CG_BM;
  const int r0 = blockIdx.x * CG_BN;
  const int h0 = r0 / M;
  const int nh = (min(r0 + CG_BN, R) - 1) / M - h0 + 1;
  const int64_t n_lo = (int64_t)blockIdx.z * rows;
  const int64_t n_hi = n_lo + rows < N ? n_lo + rows : N;
  float* dst = out + (int64_t)blockIdx.z * K * R;  // this slice's partial

  for (int c = tid; c < CG_BN; c += CG_THREADS) {
    const int r = r0 + c;
    col_h[c] = r < R ? r / M - h0 : -1;
    col_m[c] = r < R ? r % M : 0;
  }

  // the copies of the stage at n = s0 into buffer buf (one group): every
  // thread copies row nl = tid % BK of G, x0 and x1
  auto stage = [&](int64_t s0, int buf) {
    const int nl = tid % CG_BK, j0 = tid / CG_BK;
    const int64_t n = s0 + nl;
    const bool ok = n < n_hi;
    const int64_t b = ok ? n / D : 0;
    const int d = ok ? (int)(n - b * D) : 0;
    const float* gp = g + b * K * D + d;
    const float* x0p = x0 + b * M * D + d;
    const float* x1p = x1 + (b * H + h0) * D + d;
    float* gd = gs + (buf * CG_BK + nl) * CG_GLD;
    for (int kl = j0; kl < CG_BM; kl += CG_THREADS / CG_BK) {
      const bool in = ok && k0 + kl < K;
      cp_async4(gd + kl, in ? gp + (int64_t)(k0 + kl) * D : g, in);
    }
    float* x0d = x0s + (buf * CG_BK + nl) * ld0;
    for (int m = j0; m < M; m += CG_THREADS / CG_BK)
      cp_async4(x0d + m, ok ? x0p + (int64_t)m * D : x0, ok);
    float* x1d = x1s + (buf * CG_BK + nl) * ld1;
    for (int hh = j0; hh < nh; hh += CG_THREADS / CG_BK)
      cp_async4(x1d + hh, ok ? x1p + (int64_t)hh * D : x1, ok);
    cp_async_commit();
  };

  float acc[CG_TM][CG_TN];
#pragma unroll
  for (int i = 0; i < CG_TM; ++i)
#pragma unroll
    for (int j = 0; j < CG_TN; ++j) acc[i][j] = 0.f;

  const int64_t stages = n_hi > n_lo ? (n_hi - n_lo + CG_BK - 1) / CG_BK : 0;
  if (stages > 0) stage(n_lo, 0);
  for (int64_t c = 0; c < stages; ++c) {
    const int buf = (int)(c & 1);
    cp_async_wait_all();
    __syncthreads();  // stage c is in; stage c - 1 is done with everything
    if (c + 1 < stages) stage(n_lo + (c + 1) * CG_BK, buf ^ 1);
    const float* x0b = x0s + buf * CG_BK * ld0;
    const float* x1b = x1s + buf * CG_BK * ld1;
    for (int i = tid; i < CG_BK * CG_BN; i += CG_THREADS) {
      const int cc = i % CG_BN, nl = i / CG_BN;
      const int hh = col_h[cc];
      zs[i] = hh >= 0 ? x1b[nl * ld1 + hh] * x0b[nl * ld0 + col_m[cc]]
                      : 0.f;
    }
    __syncthreads();  // Z of stage c is formed
    if (tid < CG_TY * CG_TX) {
      const float* gb = gs + buf * CG_BK * CG_GLD + ty * CG_TM;
#pragma unroll
      for (int nl = 0; nl < CG_BK; ++nl) {
        const float4 a0 = *reinterpret_cast<const float4*>(gb + nl * CG_GLD);
        const float4 a1 =
            *reinterpret_cast<const float4*>(gb + nl * CG_GLD + 4);
        const float4 b0 =
            *reinterpret_cast<const float4*>(zs + nl * CG_BN + tx * CG_TN);
        const float4 b1 = *reinterpret_cast<const float4*>(
            zs + nl * CG_BN + tx * CG_TN + 4);
        const float av[CG_TM] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
        const float bv[CG_TN] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < CG_TM; ++i)
#pragma unroll
          for (int j = 0; j < CG_TN; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

  if (tid >= CG_TY * CG_TX) return;
#pragma unroll
  for (int i = 0; i < CG_TM; ++i) {
    const int k = k0 + ty * CG_TM + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < CG_TN; ++j) {
      const int r = r0 + tx * CG_TN + j;
      if (r < R) dst[(int64_t)k * R + r] = acc[i][j];
    }
  }
}

// out[i] = sum_{s < S} part[s][i], in index order
__global__ void cin_grad_split_sum_kernel(const float* __restrict__ part,
                                          float* __restrict__ out,
                                          int64_t total, int S) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < S; ++z) s += part[(int64_t)z * total + i];
    out[i] = s;
  }
}

static const size_t kMaxSmem = 232448;  // 227 KB, a block's most on sm_90

// g/x1/x0 float32; out [K, H, M] float32; `splits` slices of `rows` n
// (splits == ceil(B*D / rows), at least 1), work splits * K * H * M
// floats where splits > 1.
extern "C" int cin_weight_grad_launch(const void* g, const void* x1,
                                      const void* x0, void* out, void* work,
                                      int B, int H, int M, int D, int K,
                                      int splits, int rows, void* stream) {
  if (H <= 0 || M <= 0 || K <= 0) return 0;
  if (B < 0 || D <= 0 || rows <= 0 || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t N = (int64_t)B * D;
  const int64_t need = N > 0 ? (N + rows - 1) / rows : 1;
  if (need != splits || (int64_t)H * M > INT32_MAX - CG_BN ||
      (K + CG_BM - 1) / CG_BM > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * cg_smem_words(H, M);
  int err;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 &&
      (err = (int)cudaFuncSetAttribute(
           cin_weight_grad_kernel,
           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int R = H * M;
  const dim3 grid((unsigned)((R + CG_BN - 1) / CG_BN),
                  (unsigned)((K + CG_BM - 1) / CG_BM), (unsigned)splits);
  cin_weight_grad_kernel<<<grid, CG_THREADS, smem, st>>>(
      (const float*)g, (const float*)x1, (const float*)x0,
      splits > 1 ? (float*)work : (float*)out, B, H, M, D, K,
      (int64_t)rows);
  if ((err = (int)cudaGetLastError())) return err;
  if (splits > 1) {
    const int64_t total = (int64_t)K * R;
    const int64_t blocks = (total + 255) / 256;
    cin_grad_split_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096),
                                256, 0, st>>>((const float*)work,
                                              (float*)out, total, splits);
    err = (int)cudaGetLastError();
  }
  return err;
}

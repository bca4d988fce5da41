// xDeepFM CIN layer (Compressed Interaction Network, arXiv:1803.05170).
//
// Replaces: src/repro/kernels/cin_fuse.py:cin_layer (K11, `_cin_kernel`).
//
//   out[b, k, d] = sum_{h, m} w[k, h, m] * x1[b, h, d] * x0[b, m, d]
//
// x1 [B, H, D], x0 [B, M, D], w [K, H, M] in, all float32 or all
// bfloat16 (converted to float32 as they are staged); out [B, K, D]
// float32, accumulated in float32.
//
// What bounds it on the H100: operations. A layer does 2*B*K*H*M*D FLOP
// on B*(H + M)*D + K*H*M input values: at the model's widths (H = K =
// 200, M = 39, D = 10) ~7,800 FLOP per byte moved, far above the card's
// 3.35 TB/s. In 3xTF32 on the tensor cores it does 3x that FLOP at
// 494.7 TFLOP/s dense TF32 (H100 SXM data sheet): a bound 2.46x lower
// than the FLOP once at the 67 TFLOP/s of fp32 outside them.
//
// Arithmetic: 3xTF32. Each fp32 operand is split a = a_hi + a_lo with
// a_hi = rna_tf32(a) and a_lo = rna_tf32(a - a_hi) (round to TF32's 10-bit
// mantissa, ties away from zero: cvt.rna.tf32.f32, done with two integer
// ops), and the products a_lo*b_hi + a_hi*b_lo + a_hi*b_hi are summed.
// Each product of two TF32 values is exact in fp32 and only a_lo*b_lo
// (~2^-22 of a*b) is dropped, so the layer keeps fp32-class error (an
// emulation at the model's widths: ~5e-7 of the layer's max against
// float64, as plain fp32; single-pass TF32 ~3e-4), inside the fp32
// tolerances the kernel is held to. The tensor cores' own fp32 sums
// truncate, so they are kept short: each stage's 96 products per output
// (4 k-steps x 3 terms) are summed there from zero and added to the fp32
// accumulators with one FADD. Carrying the whole of R in the MMAs'
// accumulators (2,925 truncating sums per output at H = 200) was measured
// on the H100 an order of magnitude less accurate than the emulation.
//
// Design. The layer is the GEMM, transposed so that the output channels
// K are the MMA's N side:
//   C[n, k] = sum_r Z[n, r] * W[r, k],  n = b*D + d,  r = h*M + m,
//   Z[n, r] = x1[b, h, d] * x0[b, m, d],  W[r, k] = w[k, h, m].
// Instruction: wgmma.mma_async m64n104k8 .tf32, both operands from shared
// memory by descriptor (no-swizzle K-major core matrices, 8 rows x 16 B).
//  * A block owns 64 rows n x 208 columns k (K = 200 and 8 zero columns):
//    two warpgroups, one per 104 columns, 52 fp32 accumulators a thread.
//  * r is walked in stages of 32 (4 k-steps of 8), triple-buffered. M =
//    39 is not a multiple of 8, so h = r / M and m = r % M appear only
//    when A is formed; the tail of R (1,521 at H = 39) is zero-filled.
//  * W is laid out once per call by a small first kernel into one image
//    per (208-column block, stage): hi and lo, in exactly the shared-
//    memory layout of a stage, so each stage arrives as one contiguous
//    run of 16-byte cp.async copies (53 KB).
//  * A (Z, hi and lo) is formed in shared memory by all 256 threads, each
//    making 8 r of one row from x0 (staged once per block) and the
//    stage's x1 values (cp.async beside W), and shared by both warpgroups.
//  * Pipeline: a stage's 12 wgmmas are issued, then the threads wait for
//    the next stage's copies, issue the one after, and form the next A
//    while the tensor cores work; then the partial is folded in. Shared-
//    memory writes reach the tensor cores through fence.proxy.async.
//  * Filling the card: at B = 512 the tile grid is 80 blocks, under the
//    SM count, so the r axis is split over S blocks (S <= 8, the split
//    with the fewest stages on the busiest SM): each writes its partial
//    to a workspace slice, and a last launch adds the S slices in index
//    order, so two launches on the same inputs are bit-identical (no float
//    atomics). At bulk (N = 2.6M rows) there is no split and no workspace.
//  * Any B (the last tile masks n >= B*D) and any K (one 208-column block
//    per grid row, the store masks k >= K); bf16 is widened as it is
//    staged (its hi part is exact, its lo part 0).
// Tried on the H100 and measured slower, at the same results: the first
// kernel (SIMT fp32 FMAs; 0.9983 ms at B = 512, H = 200, slower than one
// torch.einsum call); warp-level mma.sync m16n8k8 in 64 x 40, 16 x 200
// and 32 x 104 warp tiles, with Z in shared memory or formed in
// registers and W split per warp or per block (all close to each other
// and far below mma.sync's own ceiling); cvt.rna.tf32 instead of the
// integer rounding; wgmma with A from registers (ptxas serializes the
// wgmmas for want of registers) or inside a branch (serialized too); W
// split in shared memory per stage instead of once per call; and two
// accumulator sets, to fold one stage while the next runs (serialized).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CIN_WGN 104                  // columns k per warpgroup
#define CIN_BN 64                    // rows n per block
#define CIN_BK (2 * CIN_WGN)         // 208 columns k per block
#define CIN_RK 32                    // r per stage (4 k-steps of 8)
#define CIN_THREADS 256              // two warpgroups, one per 104 columns
#define CIN_MAX_SPLITS 8
#define CIN_NBUF 3                   // stages in flight
// One stage of W (hi or lo) in the no-swizzle K-major core-matrix layout
// [k-step 4][8-column group 26][r half 2][8 columns][4 r]: a core matrix
// is 128 B, the r halves are LBO = 128 B apart and the column groups
// SBO = 256 B. A uses the same layout with 8 row groups.
#define CIN_WWORDS (CIN_RK * CIN_BK)
#define CIN_AWORDS (CIN_RK * CIN_BN)
#define CIN_LBO 128
#define CIN_SBO 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// cvt.rna.tf32.f32 by integer ops: add half of the 13 dropped bits'
// range to the magnitude, then clear them. The same bits as the cvt
// instruction for every finite value, on the integer pipe (the
// conversion unit's throughput is a fraction of it).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// shared-memory writes of the generic proxy (cp.async, stores), made
// visible to the wgmmas' async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one staged x1 value: cp.async for float (zero-filled where !ok), a
// widening load for bf16
__device__ __forceinline__ void stage_one(float* dst, const float* src,
                                          bool ok) {
  cp_async4(dst, src, ok);
}
__device__ __forceinline__ void stage_one(float* dst,
                                          const __nv_bfloat16* src, bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.f;
}

// word offset of column (or row) kl, r j in a stage image of `cols`
__device__ __forceinline__ int core_off(int kl, int j, int cols) {
  return (j >> 3) * (cols * 8) + (kl >> 3) * 64 + ((j >> 2) & 1) * 32 +
         (kl & 7) * 4 + (j & 3);
}

__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)(CIN_LBO >> 4) << 16) | ((uint64_t)(CIN_SBO >> 4) << 32);
}

// keeps the compiler from moving reads or writes of x across this point
__device__ __forceinline__ void keep(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// d (+)= A * B over one k-step (8 r) for the warpgroup's 64 rows x 104
// columns, both from shared memory by descriptor; scale_d == 0 starts d
// from zero
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51"
      "}, %52, %53, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51])
      : "l"(da), "l"(db), "r"(scale_d));
}

// most distinct h among CIN_RK consecutive r
static int cin_hs(int M) {
  const int h = (CIN_RK - 1) / M + 2;
  return h < CIN_RK ? h : CIN_RK;
}

// shared words of one block: W (hi, lo) in CIN_NBUF buffers, A (hi, lo)
// in two, x0, the x1 stages and the x1 row offsets
static size_t cin_smem_words(int M, int hs) {
  return (size_t)CIN_NBUF * 2 * CIN_WWORDS + (size_t)2 * 2 * CIN_AWORDS +
         (size_t)CIN_BN * M + (size_t)CIN_NBUF * CIN_BN * hs + 2 * CIN_BN;
}

// W laid out once per call as stage images [208-column block][stage]
// [hi, lo][CIN_WWORDS], each the shared-memory layout of one stage
template <typename T>
__global__ void cin_w_image_kernel(const T* __restrict__ w,
                                   uint32_t* __restrict__ img, int K, int R,
                                   int stages) {
  const int64_t total = (int64_t)((K + CIN_BK - 1) / CIN_BK) * stages *
                        CIN_WWORDS;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int j = (int)(i % CIN_RK);
    const int64_t rest = i / CIN_RK;
    const int kl = (int)(rest % CIN_BK);
    const int64_t bs = rest / CIN_BK;  // column block * stages + stage
    const int k = (int)(bs / stages) * CIN_BK + kl;
    const int r = (int)(bs % stages) * CIN_RK + j;
    const float v = k < K && r < R ? to_f32(w[(int64_t)k * R + r]) : 0.f;
    const uint32_t hi = tf32_rna(v);
    uint32_t* dst = img + bs * 2 * CIN_WWORDS + core_off(kl, j, CIN_BK);
    dst[0] = hi;
    dst[CIN_WWORDS] = tf32_rna(v - __uint_as_float(hi));
  }
}

template <typename T>
__global__ void __launch_bounds__(CIN_THREADS, 1)
    cin_layer_kernel(const T* __restrict__ x1, const T* __restrict__ x0,
                     const uint32_t* __restrict__ wimg,
                     float* __restrict__ out, int B, int H, int M, int D,
                     int K, int r_split, int hs, int stages_all) {
  extern __shared__ __align__(128) float smem[];
  float* wbuf = smem;                              // [NBUF][hi, lo][WWORDS]
  uint32_t* abuf = reinterpret_cast<uint32_t*>(
      wbuf + CIN_NBUF * 2 * CIN_WWORDS);           // [2][hi, lo][AWORDS]
  float* x0s = reinterpret_cast<float*>(abuf + 2 * 2 * CIN_AWORDS);
  float* x1s = x0s + CIN_BN * M;                   // [NBUF][BN][hs]
  // x1 offset of each row's (b, h = 0, d); -1 past N
  int64_t* x1off = reinterpret_cast<int64_t*>(x1s + CIN_NBUF * CIN_BN * hs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kh = warp >> 2;                  // warpgroup: 104 columns each
  const int row0 = (warp & 3) * 16;          // this warp's 16 rows of d
  const int R = H * M;
  const int64_t N = (int64_t)B * D;
  const int64_t n0 = (int64_t)blockIdx.x * CIN_BN;
  const int kb0 = blockIdx.y * CIN_BK;
  const int rs0 = blockIdx.z * r_split;
  const int rs1 = min(R, rs0 + r_split);
  float* dst = out + (int64_t)blockIdx.z * N * K;  // this split's slice

  for (int i = tid; i < CIN_BN; i += CIN_THREADS) {
    const int64_t n = n0 + i;
    x1off[i] = n < N ? (n / D) * H * D + n % D : -1;
  }
  for (int i = tid; i < CIN_BN * M; i += CIN_THREADS) {
    const int nl = i / M, m = i - nl * M;
    const int64_t n = n0 + nl;
    x0s[i] = n < N ? to_f32(x0[((n / D) * M + m) * D + n % D]) : 0.f;
  }
  __syncthreads();  // x1off

  // the copies of the stage at r0 into buffer b (one group): its W image
  // and its x1 values
  const uint32_t* wblk =
      wimg + (int64_t)blockIdx.y * stages_all * 2 * CIN_WWORDS;
  auto stage = [&](int r0, int b) {
    float* wd = wbuf + b * 2 * CIN_WWORDS;
    const uint32_t* ws = wblk + (int64_t)(r0 / CIN_RK) * 2 * CIN_WWORDS;
    for (int i = tid * 4; i < 2 * CIN_WWORDS; i += CIN_THREADS * 4)
      cp_async16(wd + i, ws + i);
    const int h0 = r0 / M;
    const int nh = (min(r0 + CIN_RK, R) - 1) / M - h0 + 1;
    float* xd = x1s + b * CIN_BN * hs;
    for (int i = tid; i < CIN_BN * nh; i += CIN_THREADS) {
      const int nl = i / nh, hh = i - nl * nh;
      const int64_t o = x1off[nl];
      stage_one(xd + nl * hs + hh, o >= 0 ? x1 + o + (int64_t)(h0 + hh) * D
                                          : x1, o >= 0);
    }
    cp_async_commit();
  };

  // stage c (buffer c % NBUF): wait for its copies, issue those of stage
  // c + 1, and form its A (hi, lo) in A buffer c & 1: thread tid makes
  // row tid % 64, r 8q .. 8q + 7 for q = tid / 64
  auto prepare = [&](int c) {
    const int b = c % CIN_NBUF, r0 = rs0 + c * CIN_RK;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // stage c is in; buffer (c + 1) % NBUF is free
    if (r0 + CIN_RK < rs1) stage(r0 + CIN_RK, (c + 1) % CIN_NBUF);
    const float* xs = x1s + b * CIN_BN * hs;
    const int nl = tid % CIN_BN, q = tid / CIN_BN;
    const int h0 = r0 / M;
    int r = r0 + 8 * q;
    int h = r / M, m = r - h * M;
    uint32_t hi[8], lo[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool ok = r + j < R;  // past R: z = 0
      const float z = ok ? xs[nl * hs + h - h0] * x0s[nl * M + m] : 0.f;
      hi[j] = tf32_rna(z);
      lo[j] = tf32_rna(z - __uint_as_float(hi[j]));
      if (++m == M) m = 0, ++h;
    }
    uint32_t* ah = abuf + (c & 1) * 2 * CIN_AWORDS;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = core_off(nl, 8 * q + 4 * half, CIN_BN);
      *reinterpret_cast<uint4*>(ah + o) =
          make_uint4(hi[4 * half], hi[4 * half + 1], hi[4 * half + 2],
                     hi[4 * half + 3]);
      *reinterpret_cast<uint4*>(ah + CIN_AWORDS + o) =
          make_uint4(lo[4 * half], lo[4 * half + 1], lo[4 * half + 2],
                     lo[4 * half + 3]);
    }
    fence_proxy_async();
  };

  float acc[CIN_WGN / 2], d[CIN_WGN / 2];
#pragma unroll
  for (int i = 0; i < CIN_WGN / 2; ++i) acc[i] = d[i] = 0.f;

  const int stages = (rs1 - rs0 + CIN_RK - 1) / CIN_RK;
  if (stages > 0) {
    stage(rs0, 0);
    prepare(0);
  }
  for (int c = 0; c < stages; ++c) {
    __syncthreads();  // A of stage c is formed by every thread
    // the stage's 12 wgmmas (small terms first), issued unconditionally:
    // a wgmma on a divergent path is serialized
    const float* wh = wbuf + (c % CIN_NBUF) * 2 * CIN_WWORDS +
                      kh * (CIN_WGN / 8) * 64;
    const float* wl = wh + CIN_WWORDS;
    const uint32_t* ah = abuf + (c & 1) * 2 * CIN_AWORDS;
    const uint32_t* al = ah + CIN_AWORDS;
#pragma unroll
    for (int i = 0; i < CIN_WGN / 2; ++i) keep(d[i]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s8 = 0; s8 < 4; ++s8) {
      const uint64_t dh = wg_desc(wh + s8 * CIN_BK * 8);
      const uint64_t dl = wg_desc(wl + s8 * CIN_BK * 8);
      const uint64_t dah = wg_desc(ah + s8 * CIN_BN * 8);
      const uint64_t dal = wg_desc(al + s8 * CIN_BN * 8);
      wgmma_tf32(d, dal, dh, s8 > 0);
      wgmma_tf32(d, dah, dl, 1);
      wgmma_tf32(d, dah, dh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (c + 1 < stages) prepare(c + 1);  // while the tensor cores work
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < CIN_WGN / 2; ++i) {
      keep(d[i]);
      acc[i] += d[i];
    }
  }

  // d layout: per 8-column tile j, [4j + q] = (row g + 8 (q >> 1),
  // column 8j + 2t + (q & 1))
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t n = n0 + row0 + g + 8 * half;
    if (n >= N) continue;
    float* row = dst + (n / D) * K * D + n % D;  // out[b, :, d]
#pragma unroll
    for (int j = 0; j < CIN_WGN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = kb0 + kh * CIN_WGN + j * 8 + 2 * t + q;
        if (k < K) row[(int64_t)k * D] = acc[4 * j + 2 * half + q];
      }
  }
}

// out[i] = sum_{s < S} part[s][i], in index order
__global__ void cin_split_sum_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int64_t total,
                                     int S) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < S; ++z) s += part[(int64_t)z * total + i];
    out[i] = s;
  }
}

static const size_t kMaxSmem = 232448;  // 227 KB, a block's most on sm_90

template <typename T>
static int set_smem(int M, size_t* smem) {
  *smem = sizeof(float) * cin_smem_words(M, cin_hs(M));
  if (*smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      cin_layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)*smem);
}

template <typename T>
static int splits(int B, int H, int M, int D, int K) {
  size_t smem;
  int err = set_smem<T>(M, &smem);
  if (err) return -err;
  int dev, sms, per_sm;
  if ((err = (int)cudaGetDevice(&dev)) ||
      (err = (int)cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev)) ||
      (err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, cin_layer_kernel<T>, CIN_THREADS, smem)))
    return -err;
  const int64_t tiles = ((int64_t)B * D + CIN_BN - 1) / CIN_BN *
                        ((K + CIN_BK - 1) / CIN_BK);
  const int stages = (H * M + CIN_RK - 1) / CIN_RK;
  const int64_t slots = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (tiles >= sms || stages < 2) return 1;
  // the split with the least work on the busiest SM: waves x stages/S
  int best = 1;
  double best_cost = (double)((tiles + slots - 1) / slots) * stages;
  for (int s = 2; s <= CIN_MAX_SPLITS && s <= stages; ++s) {
    const int per = (stages + s - 1) / s;
    const int64_t blocks = tiles * ((stages + per - 1) / per);
    const double cost = (double)((blocks + slots - 1) / slots) * per;
    if (cost < best_cost) best = s, best_cost = cost;
  }
  const int per = (stages + best - 1) / best;  // stages per split
  return (stages + per - 1) / per;             // no empty split
}

// The r-axis splits a launch at these shapes uses (>= 1), or -cudaError.
extern "C" int cin_layer_splits(int B, int H, int M, int D, int K,
                                int bf16) {
  if (B <= 0 || D <= 0 || K <= 0 || H <= 0 || M <= 0) return 1;
  return bf16 ? splits<__nv_bfloat16>(B, H, M, D, K)
              : splits<float>(B, H, M, D, K);
}

template <typename T>
static int launch(const void* x1, const void* x0, const void* w, void* out,
                  void* work, void* wimg, int B, int H, int M, int D, int K,
                  int S, cudaStream_t stream) {
  size_t smem;
  int err = set_smem<T>(M, &smem);
  if (err) return err;
  const int R = H * M;
  const int stages = (R + CIN_RK - 1) / CIN_RK;
  const int per = (stages + S - 1) / S;
  const int64_t N = (int64_t)B * D;
  const int64_t words = (int64_t)((K + CIN_BK - 1) / CIN_BK) * stages *
                        CIN_WWORDS;
  const int64_t sblocks = (words + 255) / 256;
  cin_w_image_kernel<T><<<(unsigned)(sblocks < 8192 ? sblocks : 8192), 256, 0,
                          stream>>>((const T*)w, (uint32_t*)wimg, K, R,
                                    stages);
  if ((err = (int)cudaGetLastError())) return err;
  const dim3 grid((unsigned)((N + CIN_BN - 1) / CIN_BN),
                  (unsigned)((K + CIN_BK - 1) / CIN_BK), (unsigned)S);
  cin_layer_kernel<T><<<grid, CIN_THREADS, smem, stream>>>(
      (const T*)x1, (const T*)x0, (const uint32_t*)wimg,
      S > 1 ? (float*)work : (float*)out, B, H, M, D, K, per * CIN_RK,
      cin_hs(M), stages);
  if ((err = (int)cudaGetLastError())) return err;
  if (S > 1) {
    const int64_t total = N * K;
    const int64_t blocks = (total + 255) / 256;
    cin_split_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                           stream>>>((const float*)work, (float*)out, total,
                                     S);
    err = (int)cudaGetLastError();
  }
  return err;
}

// 32-bit words of the W stage images at these shapes (the wimg argument)
extern "C" long long cin_layer_wimg_words(int H, int M, int K) {
  if (H <= 0 || M <= 0 || K <= 0) return 0;
  const long long stages = ((long long)H * M + CIN_RK - 1) / CIN_RK;
  return (long long)((K + CIN_BK - 1) / CIN_BK) * stages * 2 * CIN_WWORDS;
}

// x1/x0/w float32 (bf16 == 0) or bfloat16 (bf16 == 1); out float32;
// splits from cin_layer_splits, work S * B * K * D floats where S > 1,
// wimg cin_layer_wimg_words(H, M, K) words.
extern "C" int cin_layer_launch(const void* x1, const void* x0,
                                const void* w, void* out, void* work,
                                void* wimg, int B, int H, int M, int D, int K,
                                int bf16, int splits, void* stream) {
  if (B <= 0 || D <= 0 || K <= 0) return 0;
  if (H < 0 || M < 0 || splits < 1 || splits > CIN_MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * D > (int64_t)INT32_MAX * CIN_BN || K > 65535 * CIN_BK ||
      (int64_t)H * M > INT32_MAX - CIN_RK)
    return (int)cudaErrorInvalidValue;
  if (H == 0 || M == 0) {  // an empty sum: zeros
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * B * D * K,
                                (cudaStream_t)stream);
  }
  return bf16 ? launch<__nv_bfloat16>(x1, x0, w, out, work, wimg, B, H, M, D,
                                      K, splits, (cudaStream_t)stream)
              : launch<float>(x1, x0, w, out, work, wimg, B, H, M, D, K,
                              splits, (cudaStream_t)stream);
}

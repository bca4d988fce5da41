// xDeepFM CIN layer, K11's narrow-output instance: the calls with at most
// 64 output channels, which the CIN's backward makes.
//
// Replaces: src/repro/kernels/cin_fuse.py:cin_layer (K11, `_cin_kernel`)
// at the shapes `ops.CinLayer.backward` gives it: dx0 of every layer (K'
// = M = 39 output channels, M' = the layer's input width, 39 or 200) and
// dx1 of the first layer (K' = 39). The wide kernel (csrc/cin_fuse.cu)
// keeps every call with K > 64: the forward (K = 200), serving, and dx1
// of the 200-wide layers.
//
//   out[b, k, d] = sum_{h, m} w[k, h, m] * x1[b, h, d] * x0[b, m, d]
//
// x1 [B, H, D], x0 [B, M, D], w [K, H, M] float32 in (K <= 64; bfloat16
// goes to the wide kernel); out [B, K, D] float32.
//
// What bounds it on the H100: operations, as K11. dx0 of a 200-wide layer
// at train_batch (B = 65,536, H = M = 200, K = 39, D = 10) is 2*B*D*K*H*M
// = 2.04e12 FLOP, three times that in 3xTF32 at 494.7 TFLOP/s dense TF32
// (12.4 ms), on 0.6 GB of inputs and output (0.2 ms at 3.35 TB/s).
//
// Why not K11's design: K11 forms A = Z = x1 * x0 (hi and lo) for every
// stage and runs it against 208 output columns. At K = 39, 81% of every
// wgmma's columns are padding, so forming A costs ~5x what it costs in
// the forward per useful FLOP, and K11's resident x0 caps M at 148.
//
// Design: the sum factorized so that no outer product is formed.
//   P[n, (m, k)] = sum_h x1[n, h] * w[k, h, m]     a GEMM, n = b*D + d
//   out[n, k]    = sum_m x0[n, m] * P[n, (m, k)]     the epilogue
//  * The GEMM's A operand is x1 itself (64 rows n x 8 h a k-step) and B is
//    w laid out once per call by a small first kernel as TF32 hi/lo images
//    in the shared-memory layout of a (stage, chunk): columns (m, k) with
//    k fastest, padded to KP = 8 * ceil(K / 8), 200 columns a chunk (MPC =
//    25 / (KP / 8) values of m; at K = 39: 5 m x 40 k, nothing wasted).
//    Instruction: wgmma.mma_async m64n200k8 .tf32, both operands from
//    shared memory (K11's no-swizzle K-major core matrices).
//  * A block owns 128 rows n (two warpgroups, 64 rows each, sharing every
//    B stage). h is walked in stages of 40 (5 k-steps; H = 200 is 5
//    stages); within a stage, the chunks of (m, k) columns. A stage's A
//    (x1, hi and lo, 40 KB) is formed once from device memory and serves
//    every chunk; the chunks' B images stream through two 64 KB buffers
//    by 16-byte cp.async, the next one in flight while this one runs.
//  * Column c = m_local * KP + k and column c + KP fall in the same thread
//    of wgmma's accumulator layout (KP is a multiple of 8), so the
//    epilogue's sum over m stays inside each thread: after each (stage,
//    chunk) the thread adds x0[n, m] * d[n, (m, k)] into its 2 rows x
//    2 * KP / 8 output accumulators (x0 loaded into registers while the
//    tensor cores work). x0 is never staged whole, so M is not bounded by
//    shared memory: dx0 of a 200-wide layer is one call.
//  * Arithmetic: 3xTF32 by K11's discipline (csrc/cin_fuse.cu): both
//    operands split a = a_hi + a_lo (round to TF32, ties away), the
//    products a_lo*b_hi + a_hi*b_lo + a_hi*b_hi; each (stage, chunk)'s 120
//    products per output (5 k-steps x 8 x 3) are summed by the tensor
//    cores from zero and folded into the fp32 accumulators with one FMA.
//    Every sum is taken in a fixed order and nothing is atomic: two
//    launches on the same inputs are bit-identical.
//  * Any B (the last block masks n >= B*D), any H and M, any K <= 64.
#include <cuda_runtime.h>
#include <stdint.h>

#define CN_BM 128                  // rows n per block: two warpgroups
#define CN_BN 200                  // columns (m, k) per chunk: m64n200k8
#define CN_KS 5                    // k-steps (8 h each) per stage
#define CN_SH (8 * CN_KS)          // h per stage
#define CN_THREADS 256
#define CN_MAX_K 64
// A (hi or lo) of a stage and B (hi or lo) of a (stage, chunk), in the
// no-swizzle K-major core-matrix layout [k-step][8-row group][h half 2]
// [8 rows][4 h]: a core matrix is 128 B, the h halves LBO = 128 B apart,
// the row groups SBO = 256 B
#define CN_AWORDS (CN_SH * CN_BM)  // 5,120
#define CN_BWORDS (CN_SH * CN_BN)  // 8,000
#define CN_LBO 128
#define CN_SBO 256
// shared memory: A (hi, lo) once, B (hi, lo) in two buffers
#define CN_SMEM_BYTES (4 * (2 * CN_AWORDS + 2 * 2 * CN_BWORDS))

// cvt.rna.tf32.f32 by integer ops (K11's rounding)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
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

// shared-memory writes of the generic proxy made visible to the wgmmas
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// word offset of row (or column) kl, k-index j in an image of `cols`
__device__ __forceinline__ int core_off(int kl, int j, int cols) {
  return (j >> 3) * (cols * 8) + (kl >> 3) * 64 + ((j >> 2) & 1) * 32 +
         (kl & 7) * 4 + (j & 3);
}

__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)(CN_LBO >> 4) << 16) | ((uint64_t)(CN_SBO >> 4) << 32);
}

// keeps the compiler from moving reads or writes of x across this point
__device__ __forceinline__ void keep(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// d (+)= A * B over one k-step (8 h) for the warpgroup's 64 rows x 200
// columns; scale_d == 0 starts d from zero
__device__ __forceinline__ void wgmma_n200(float* d, uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %102, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99"
      "}, %100, %101, p, 1, 1;\n}\n"
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
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "l"(da), "l"(db), "r"(scale_d));
}

// values of m in a chunk at kq = KP / 8
static __host__ __device__ inline int cn_mpc(int kq) { return 25 / kq; }

// w laid out once per call as images [stage][chunk][hi, lo][CN_BWORDS],
// each the shared-memory layout of one (stage, chunk); zero past H, past
// M, past K and in the columns a chunk leaves unused
__global__ void cin_narrow_w_image_kernel(const float* __restrict__ w,
                                          uint32_t* __restrict__ img, int K,
                                          int H, int M, int kq, int chunks,
                                          int stages) {
  const int KP = 8 * kq, mpc = cn_mpc(kq);
  const int64_t total = (int64_t)stages * chunks * CN_BWORDS;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int j = (int)(i % CN_SH);
    const int col = (int)(i / CN_SH % CN_BN);
    const int64_t sc = i / CN_BWORDS;  // stage * chunks + chunk
    const int h = (int)(sc / chunks) * CN_SH + j;
    const int ml = col / KP, k = col - ml * KP;
    const int m = (int)(sc % chunks) * mpc + ml;
    const float v = h < H && k < K && ml < mpc && m < M
                        ? w[((int64_t)k * H + h) * M + m]
                        : 0.f;
    const uint32_t hi = tf32_rna(v);
    uint32_t* dst = img + sc * 2 * CN_BWORDS + core_off(col, j, CN_BN);
    dst[0] = hi;
    dst[CN_BWORDS] = tf32_rna(v - __uint_as_float(hi));
  }
}

template <int KQ>
__global__ void __launch_bounds__(CN_THREADS, 1)
    cin_narrow_kernel(const float* __restrict__ x1,
                      const float* __restrict__ x0,
                      const uint32_t* __restrict__ wimg,
                      float* __restrict__ out, int B, int H, int M, int D,
                      int K, int stages, int chunks) {
  constexpr int MPC = 25 / KQ;   // m per chunk
  constexpr int NT = MPC * KQ;   // 8-column tiles that hold a real m
  extern __shared__ __align__(128) uint32_t smem[];
  uint32_t* abuf = smem;                   // [hi, lo][CN_AWORDS]
  uint32_t* bbuf = smem + 2 * CN_AWORDS;   // [2][hi, lo][CN_BWORDS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;                // warpgroup: 64 rows each
  const int64_t N = (int64_t)B * D;
  const int64_t n0 = (int64_t)blockIdx.x * CN_BM;

  // the thread's two accumulator rows (g and g + 8 of its warp's 16) and
  // the x0 offset of each one's (b, m = 0, d); -1 past N
  int64_t xrow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int64_t n = n0 + wg * 64 + (warp & 3) * 16 + g + 8 * hr;
    xrow[hr] = n < N ? (n / D) * M * D + n % D : -1;
  }
  // A is formed by row fl, h 20 * fq .. 20 * fq + 19 of each stage
  const int fl = tid & (CN_BM - 1), fq = tid >> 7;
  const int64_t fn = n0 + fl;
  const int64_t x1row = fn < N ? (fn / D) * H * D + fn % D : -1;

  float o[2][2 * KQ], d[CN_BN / 2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int i = 0; i < 2 * KQ; ++i) o[hr][i] = 0.f;
#pragma unroll
  for (int i = 0; i < CN_BN / 2; ++i) d[i] = 0.f;

  // the 16-byte copies of (stage, chunk) image `it` into B buffer `buf`
  const int total = stages * chunks;
  auto copy_b = [&](int it, int buf) {
    const uint32_t* src = wimg + (int64_t)it * 2 * CN_BWORDS;
    uint32_t* dst = bbuf + buf * 2 * CN_BWORDS;
    for (int i = tid * 4; i < 2 * CN_BWORDS; i += CN_THREADS * 4)
      cp_async16(dst + i, src + i);
    cp_async_commit();
  };

  copy_b(0, 0);
  int it = 0;
  for (int s = 0; s < stages; ++s) {
    __syncthreads();  // the last stage's wgmmas are done with A
    const int h0 = s * CN_SH;
#pragma unroll
    for (int p = 0; p < CN_SH / 8; ++p) {
      const int j = (CN_SH / 2) * fq + 4 * p;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = h0 + j + e;
        const float v = x1row >= 0 && h < H
                            ? __ldg(x1 + x1row + (int64_t)h * D)
                            : 0.f;
        hi[e] = tf32_rna(v);
        lo[e] = tf32_rna(v - __uint_as_float(hi[e]));
      }
      const int off = core_off(fl, j, CN_BM);
      *reinterpret_cast<uint4*>(abuf + off) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(abuf + CN_AWORDS + off) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    fence_proxy_async();
    for (int c = 0; c < chunks; ++c, ++it) {
      cp_async_wait_all();
      fence_proxy_async();
      __syncthreads();  // image `it` is in, A is formed; the other B
                        // buffer's wgmmas are done
      if (it + 1 < total) copy_b(it + 1, (it + 1) & 1);
      // x0 of the chunk's m for the thread's two rows, loaded while the
      // tensor cores work
      float xv[2][MPC];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int ml = 0; ml < MPC; ++ml) {
          const int m = c * MPC + ml;
          xv[hr][ml] = xrow[hr] >= 0 && m < M
                           ? __ldg(x0 + xrow[hr] + (int64_t)m * D)
                           : 0.f;
        }
      // the 15 wgmmas (small terms first), issued unconditionally: a
      // wgmma on a divergent path is serialized
      const uint32_t* bh = bbuf + (it & 1) * 2 * CN_BWORDS;
      const uint32_t* bl = bh + CN_BWORDS;
      const uint32_t* ah = abuf + wg * 8 * 64;  // the warpgroup's 64 rows
      const uint32_t* al = ah + CN_AWORDS;
#pragma unroll
      for (int i = 0; i < CN_BN / 2; ++i) keep(d[i]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < CN_KS; ++ks) {
        const uint64_t dbh = wg_desc(bh + ks * CN_BN * 8);
        const uint64_t dbl = wg_desc(bl + ks * CN_BN * 8);
        const uint64_t dah = wg_desc(ah + ks * CN_BM * 8);
        const uint64_t dal = wg_desc(al + ks * CN_BM * 8);
        wgmma_n200(d, dal, dbh, ks > 0);
        wgmma_n200(d, dah, dbl, 1);
        wgmma_n200(d, dah, dbh, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < CN_BN / 2; ++i) keep(d[i]);
      // d layout: per 8-column tile j, [4j + q] = (row g + 8 (q >> 1),
      // column 8j + 2t + (q & 1)); column 8j + e holds m = j / KQ and
      // k = 8 (j % KQ) + e
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float& acc = o[q >> 1][2 * (j % KQ) + (q & 1)];
          acc = fmaf(xv[q >> 1][j / KQ], d[4 * j + q], acc);
        }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (xrow[hr] < 0) continue;
    const int64_t n = n0 + wg * 64 + (warp & 3) * 16 + g + 8 * hr;
    float* row = out + (n / D) * K * D + n % D;  // out[b, :, d]
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * kk + 2 * t + e;
        if (k < K) row[(int64_t)k * D] = o[hr][2 * kk + e];
      }
  }
}

template <int KQ>
static int launch_kq(const float* x1, const float* x0, const uint32_t* wimg,
                     float* out, int B, int H, int M, int D, int K,
                     int stages, int chunks, cudaStream_t stream) {
  int err = (int)cudaFuncSetAttribute(
      cin_narrow_kernel<KQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      CN_SMEM_BYTES);
  if (err) return err;
  const int64_t N = (int64_t)B * D;
  cin_narrow_kernel<KQ><<<(unsigned)((N + CN_BM - 1) / CN_BM), CN_THREADS,
                          CN_SMEM_BYTES, stream>>>(x1, x0, wimg, out, B, H,
                                                   M, D, K, stages, chunks);
  return (int)cudaGetLastError();
}

static void cn_plan(int H, int M, int K, int* kq, int* stages, int* chunks) {
  *kq = (K + 7) / 8;
  *stages = (H + CN_SH - 1) / CN_SH;
  *chunks = (M + cn_mpc(*kq) - 1) / cn_mpc(*kq);
}

// 32-bit words of the w images at these shapes (the wimg argument)
extern "C" long long cin_narrow_wimg_words(int H, int M, int K) {
  if (H <= 0 || M <= 0 || K <= 0 || K > CN_MAX_K) return 0;
  int kq, stages, chunks;
  cn_plan(H, M, K, &kq, &stages, &chunks);
  return (long long)stages * chunks * 2 * CN_BWORDS;
}

// x1/x0/w float32, K <= 64; out float32 [B, K, D]; wimg
// cin_narrow_wimg_words(H, M, K) words.
extern "C" int cin_narrow_launch(const void* x1, const void* x0,
                                 const void* w, void* out, void* wimg, int B,
                                 int H, int M, int D, int K, void* stream) {
  if (B <= 0 || D <= 0 || K <= 0) return 0;
  if (H < 0 || M < 0 || K > CN_MAX_K ||
      (int64_t)B * D > (int64_t)INT32_MAX * CN_BM ||
      (int64_t)H * M > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (H == 0 || M == 0)  // an empty sum: zeros
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * B * D * K, st);
  int kq, stages, chunks;
  cn_plan(H, M, K, &kq, &stages, &chunks);
  const int64_t words = (int64_t)stages * chunks * CN_BWORDS;
  const int64_t blocks = (words + 255) / 256;
  cin_narrow_w_image_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256,
                              0, st>>>((const float*)w, (uint32_t*)wimg, K,
                                       H, M, kq, chunks, stages);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const float *a = (const float*)x1, *b = (const float*)x0;
  const uint32_t* wi = (const uint32_t*)wimg;
  float* o = (float*)out;
  switch (kq) {
    case 1: return launch_kq<1>(a, b, wi, o, B, H, M, D, K, stages, chunks, st);
    case 2: return launch_kq<2>(a, b, wi, o, B, H, M, D, K, stages, chunks, st);
    case 3: return launch_kq<3>(a, b, wi, o, B, H, M, D, K, stages, chunks, st);
    case 4: return launch_kq<4>(a, b, wi, o, B, H, M, D, K, stages, chunks, st);
    case 5: return launch_kq<5>(a, b, wi, o, B, H, M, D, K, stages, chunks, st);
    case 6: return launch_kq<6>(a, b, wi, o, B, H, M, D, K, stages, chunks, st);
    case 7: return launch_kq<7>(a, b, wi, o, B, H, M, D, K, stages, chunks, st);
    default:
      return launch_kq<8>(a, b, wi, o, B, H, M, D, K, stages, chunks, st);
  }
}

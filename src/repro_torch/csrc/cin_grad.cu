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
// float32 out. As a GEMM, K11's with the roles transposed:
//   C[r, k] = sum_n Z[n, r] * G[n, k],  n = b*D + d,  r = h*M + m,
//   Z[n, r] = x1[b, h, d] * x0[b, m, d],  G[n, k] = g[b, k, d],
// with Z formed in shared memory stage by stage, never in global memory.
//
// What bounds it on the H100: operations. 2*K*H*M*B*D FLOP on
// B*(K + H + M)*D + K*H*M values: at train_batch (B = 65,536) and the
// model's widths (K = H = 200, M = 39, D = 10) 2.04e12 FLOP on 0.5 GB,
// ~4,000 FLOP per byte. In 3xTF32 on the tensor cores that is 3x the FLOP
// at 494.7 TFLOP/s dense TF32 (12.4 ms), against 30.5 ms for the FLOP
// once at the 67 TFLOP/s of fp32 outside them.
//
// Arithmetic: 3xTF32, K11's (csrc/cin_fuse.cu): each operand split a =
// a_hi + a_lo (round to TF32, ties away from zero), the products
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi. The contraction is 655,360 long at
// train_batch; the tensor cores' truncating sums are kept short: each
// stage's 72 products per output (3 k-steps x 8 n x 3 terms) are summed
// there from zero and added to fp32 accumulators with one FADD.
//
// Design. Instruction: wgmma.mma_async m64n200k8 .tf32, both operands
// from shared memory by descriptor (no-swizzle K-major core matrices, 8
// rows x 16 B). `.tf32` has no transpose, so both operands are laid out
// with n contiguous.
//  * A block owns 128 rows r x 200 columns k of C (all of K = 200): two
//    warpgroups, 64 rows each, sharing every B stage; 100 fp32
//    accumulators a thread beside the wgmmas' 100 (248 registers, no
//    spill); the n range of one contraction slice (grid z). Each byte of
//    G read from L2 serves 128 rows, as in the narrow K11 kernel.
//  * n is walked in stages of 24 (3 k-steps; the shared memory of three
//    G stages, two A stages and two x stages). G is laid out once per
//    call by a small first kernel as TF32 hi/lo images, one per (stage,
//    200-column block), in exactly the shared-memory layout of a stage,
//    so each stage's B arrives as one contiguous run of 16-byte cp.async
//    copies (38 KB; three buffers, as K11's W).
//  * The x1 and x0 channels the tile's 128 r touch are copied per stage
//    ([channel x 24 n]) with 4-byte cp.async, 24 consecutive n a warp (n
//    = b*D + d runs along d in memory), double-buffered; rows 28 words
//    apart, so the float4 reads below meet no bank conflict. All 256
//    threads form A = Z^T (x1 * x0 of each r, four n a thread-task, hi
//    and lo) in the wgmma layout, two buffers. As in K11, a stage's 9
//    wgmmas are issued, then the threads wait for the next stage's copies,
//    issue the one after, and form the next stage's A while the tensor
//    cores work; then the partial is folded in.
//  * The contraction is cut into S slices (the grid's z). S is the host's
//    choice (`cin_fuse.cin_grad_splits`): the split with the least work
//    on the busiest SM, e.g. 11 slices for the 12 r-tiles of H = 39 (132
//    blocks: one full wave) and 54 for the 61 of H = 200. Each block
//    writes its partial tile to its workspace slice and a last launch adds
//    the S slices in index order: no float atomics, two launches on the
//    same inputs are bit-identical.
// Measured on the H100 and replaced (NVIDIA H100 80GB HBM3, 700 W; ms at
// train_batch, layers 1-2 / layer 0):
//  * 64 r x 208 k blocks (K11's tile: two warpgroups of m64n104, one per
//    104 columns), 32-n stages, G from the same images: 40.57 / 8.49 ms
//    (50.4 TFLOP/s): each byte of G serves only 64 rows, and the images'
//    L2 traffic bounds it as it bounds K11's wide kernel.
//  * The same with G staged raw (4-byte cp.async, [K x 32 n]) and split
//    into hi/lo in shared memory each stage: 63.08 / 12.65 ms (32.4
//    TFLOP/s): the split's shared-memory traffic and instructions (~80 KB
//    and ~400 a thread a stage) on top of K11's.
//  * SIMT fp32, 200 (k) x 80 (r) tiles of 8 x 8 a thread, cp.async double
//    buffer, 40 contraction slices of 16,384 n: 77.13 / 18.49 ms (26.5
//    TFLOP/s; 2.5x its SIMT fp32 bound).
//  * SIMT fp32, a 64 (k) x 128 (r) tile of 4 x 8 a thread, staged through
//    registers with four barriers a stage: 196.94 / 41.41 ms (10.4
//    TFLOP/s).
#include <cuda_runtime.h>
#include <stdint.h>

#define CG_BM 128                   // rows r per block: two warpgroups
#define CG_BK 200                   // columns k per block: m64n200k8
#define CG_SN 24                    // n per stage (3 k-steps of 8)
#define CG_KS (CG_SN / 8)
#define CG_THREADS 256
#define CG_RS 28                    // staged row stride (words): 24 n + 4
#define CG_NX 130                   // most x1 plus x0 channels of a tile
#define CG_MAX_SPLITS 64
#define CG_NBUF 3                   // G stages in flight
// A (hi or lo) of a stage: [k-step 3][8-row group 16][n half 2][8 rows]
// [4 n]; B likewise with 25 column groups. A core matrix is 128 B, the n
// halves LBO = 128 B apart, the row (column) groups SBO = 256 B.
#define CG_AWORDS (CG_SN * CG_BM)   // 3,072
#define CG_GWORDS (CG_SN * CG_BK)   // 4,800
#define CG_LBO 128
#define CG_SBO 256

// cvt.rna.tf32.f32 by integer ops (K11's rounding)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// one 4-byte copy global -> shared, zero-filled where !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
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

// shared-memory writes of the generic proxy made visible to the wgmmas
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// word offset of row (or column) kl, n j in a stage image of `cols`
__device__ __forceinline__ int core_off(int kl, int j, int cols) {
  return (j >> 3) * (cols * 8) + (kl >> 3) * 64 + ((j >> 2) & 1) * 32 +
         (kl & 7) * 4 + (j & 3);
}

__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)(CG_LBO >> 4) << 16) | ((uint64_t)(CG_SBO >> 4) << 32);
}

// keeps the compiler from moving reads or writes of x across this point
__device__ __forceinline__ void keep(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// the hi and lo TF32 parts of four values, stored as one uint4 each
__device__ __forceinline__ void put_split(uint32_t* hi_dst, uint32_t* lo_dst,
                                          float4 v) {
  const uint32_t h0 = tf32_rna(v.x), h1 = tf32_rna(v.y), h2 = tf32_rna(v.z),
                 h3 = tf32_rna(v.w);
  *reinterpret_cast<uint4*>(hi_dst) = make_uint4(h0, h1, h2, h3);
  *reinterpret_cast<uint4*>(lo_dst) = make_uint4(
      tf32_rna(v.x - __uint_as_float(h0)), tf32_rna(v.y - __uint_as_float(h1)),
      tf32_rna(v.z - __uint_as_float(h2)), tf32_rna(v.w - __uint_as_float(h3)));
}

// d (+)= A * B over one k-step (8 n) for the warpgroup's 64 rows x 200
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

// the most x1 channels (h) and x0 channels (m) one tile of 128 r touches
static int cg_nh(int H, int M) {
  const int h = (CG_BM - 1) / M + 2;
  return h < H ? h : H;
}
static int cg_nm(int M) { return M < CG_BM ? M : CG_BM; }

// shared words of a block: G images (hi, lo) in CG_NBUF buffers, A
// images (hi, lo) in two, the staged x rows in two
static size_t cg_smem_words(int H, int M) {
  return (size_t)CG_NBUF * 2 * CG_GWORDS + (size_t)2 * 2 * CG_AWORDS +
         (size_t)2 * CG_RS * (cg_nh(H, M) + cg_nm(M));
}

// G laid out once per call as stage images [stage][200-column block]
// [hi, lo][CG_GWORDS], each the shared-memory layout of one stage (zero
// past N and past K); a thread writes four n of one column
__global__ void cin_grad_g_image_kernel(const float* __restrict__ g,
                                        uint32_t* __restrict__ img, int B,
                                        int D, int K, int64_t stages,
                                        int kblocks) {
  const int64_t N = (int64_t)B * D;
  const int64_t total = stages * kblocks * CG_BK * (CG_SN / 4);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int q = (int)(i % (CG_SN / 4));
    const int kl = (int)(i / (CG_SN / 4) % CG_BK);
    const int64_t sk = i / (CG_BK * (CG_SN / 4));  // stage * kblocks + kb
    const int k = (int)(sk % kblocks) * CG_BK + kl;
    const int64_t n0 = sk / kblocks * CG_SN + 4 * q;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t n = n0 + e;
      v[e] = n < N && k < K ? g[(n / D * K + k) * D + n % D] : 0.f;
    }
    uint32_t* dst = img + sk * 2 * CG_GWORDS + core_off(kl, 4 * q, CG_BK);
    put_split(dst, dst + CG_GWORDS, make_float4(v[0], v[1], v[2], v[3]));
  }
}

__global__ void __launch_bounds__(CG_THREADS, 1)
    cin_weight_grad_kernel(const uint32_t* __restrict__ gsrc,
                           const float* __restrict__ x1,
                           const float* __restrict__ x0,
                           float* __restrict__ out, int B, int H, int M,
                           int D, int K, int nx, int64_t rows) {
  extern __shared__ __align__(128) float smem[];
  __shared__ int xch[CG_NX];          // channel of each staged x row
  __shared__ int ri1[CG_BM], ri0[CG_BM];  // x row of r's h and m; -1 past R
  uint32_t* gimg = reinterpret_cast<uint32_t*>(smem);  // [NBUF][hi,lo][GW]
  uint32_t* aimg = gimg + CG_NBUF * 2 * CG_GWORDS;     // [2][hi,lo][AWORDS]
  float* xraw = reinterpret_cast<float*>(aimg + 2 * 2 * CG_AWORDS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;                 // warpgroup: 64 rows r each
  const int R = H * M;
  const int64_t N = (int64_t)B * D;
  const int r0 = blockIdx.x * CG_BM;
  const int kb0 = blockIdx.y * CG_BK;
  const int64_t n_lo = (int64_t)blockIdx.z * rows;
  const int64_t n_hi = n_lo + rows < N ? n_lo + rows : N;
  float* dst = out + (int64_t)blockIdx.z * K * R;  // this slice's partial

  // the tile's x1 channels h0 .. h0 + nh - 1 (staged rows 0 .. nh - 1),
  // then its x0 channels (rows nh ..): all M where M <= 128, else the m
  // of its r in order
  const int h0 = r0 / M;
  const int nh = (min(r0 + CG_BM, R) - 1) / M - h0 + 1;
  const bool all_m = M <= CG_BM;
  const int nm = all_m ? M : min(CG_BM, R - r0);
  for (int i = tid; i < nh + nm; i += CG_THREADS)
    xch[i] = i < nh ? h0 + i : (all_m ? i - nh : (r0 + i - nh) % M);
  for (int i = tid; i < CG_BM; i += CG_THREADS) {
    const int r = r0 + i;
    ri1[i] = r < R ? r / M - h0 : -1;
    ri0[i] = nh + (all_m ? r % M : i);
  }
  __syncthreads();

  // the copies of stage c (n = n_lo + 24 c) into G buffer c % NBUF (its
  // image, 16 bytes a copy) and x buffer c & 1 (lane = n - n_lo - 24 c
  // for lanes < 24, rows warp, warp + 8, ...), one group
  const int kblocks = gridDim.y;
  const int64_t c0 = n_lo / CG_SN;          // the slice's first stage
  auto stage = [&](int64_t c) {
    const uint32_t* gs = gsrc + ((c0 + c) * kblocks + blockIdx.y) * 2 *
                                    CG_GWORDS;
    uint32_t* gd = gimg + (int)(c % CG_NBUF) * 2 * CG_GWORDS;
    for (int i = tid * 4; i < 2 * CG_GWORDS; i += CG_THREADS * 4)
      cp_async16(gd + i, gs + i);
    const int64_t n = n_lo + c * CG_SN + lane;
    const bool ok = n < n_hi;
    const int64_t b = ok ? n / D : 0;
    const int d = ok ? (int)(n - b * D) : 0;
    float* xd = xraw + (int)(c & 1) * nx * CG_RS + lane;
    if (lane < CG_SN)
      for (int i = warp; i < nh + nm; i += CG_THREADS / 32) {
        const float* src = i < nh ? x1 + (b * H + xch[i]) * D + d
                                  : x0 + (b * M + xch[i]) * D + d;
        cp_async4(xd + i * CG_RS, ok ? src : x1, ok);
      }
    cp_async_commit();
  };

  // stage c: wait for its copies, issue those of stage c + 1, and form
  // its A (hi, lo) in A buffer c & 1. A thread-task is four n (a float4 of
  // a staged row) of one r: tasks run 8 r fastest, so each quarter-warp
  // reads and writes 128 bytes without a bank conflict
  const int64_t stages = n_hi > n_lo ? (n_hi - n_lo + CG_SN - 1) / CG_SN : 0;
  auto prepare = [&](int64_t c) {
    const int buf = (int)(c & 1);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // stage c is in; G buffer (c + 1) % NBUF and x
                      // buffer (c + 1) & 1 are free
    if (c + 1 < stages) stage(c + 1);
    const float* xr = xraw + buf * nx * CG_RS;
    uint32_t* ai = aimg + buf * 2 * CG_AWORDS;
    for (int i = tid; i < CG_BM * (CG_SN / 4); i += CG_THREADS) {
      const int rl = i / (8 * (CG_SN / 4)) * 8 + (i & 7);
      const int q = (i >> 3) % (CG_SN / 4);
      float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ri1[rl] >= 0) {
        const float4 a =
            *reinterpret_cast<const float4*>(xr + ri1[rl] * CG_RS + 4 * q);
        const float4 e =
            *reinterpret_cast<const float4*>(xr + ri0[rl] * CG_RS + 4 * q);
        z = make_float4(a.x * e.x, a.y * e.y, a.z * e.z, a.w * e.w);
      }
      const int o = core_off(rl, 4 * q, CG_BM);
      put_split(ai + o, ai + CG_AWORDS + o, z);
    }
    fence_proxy_async();
  };

  float acc[CG_BK / 2], d[CG_BK / 2];
#pragma unroll
  for (int i = 0; i < CG_BK / 2; ++i) acc[i] = d[i] = 0.f;

  if (stages > 0) {
    stage(0);
    prepare(0);
  }
  for (int64_t c = 0; c < stages; ++c) {
    __syncthreads();  // stage c is formed by every thread
    // the stage's 9 wgmmas (small terms first), issued unconditionally:
    // a wgmma on a divergent path is serialized
    const uint32_t* bh = gimg + (int)(c % CG_NBUF) * 2 * CG_GWORDS;
    const uint32_t* bl = bh + CG_GWORDS;
    const uint32_t* ah = aimg + (c & 1) * 2 * CG_AWORDS + wg * 8 * 64;
    const uint32_t* al = ah + CG_AWORDS;
#pragma unroll
    for (int i = 0; i < CG_BK / 2; ++i) keep(d[i]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s8 = 0; s8 < CG_KS; ++s8) {
      const uint64_t dh = wg_desc(bh + s8 * CG_BK * 8);
      const uint64_t dl = wg_desc(bl + s8 * CG_BK * 8);
      const uint64_t dah = wg_desc(ah + s8 * CG_BM * 8);
      const uint64_t dal = wg_desc(al + s8 * CG_BM * 8);
      wgmma_n200(d, dal, dh, s8 > 0);
      wgmma_n200(d, dah, dl, 1);
      wgmma_n200(d, dah, dh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (c + 1 < stages) prepare(c + 1);  // while the tensor cores work
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < CG_BK / 2; ++i) {
      keep(d[i]);
      acc[i] += d[i];
    }
  }

  // d layout: per 8-column tile j, [4j + q] = (row gq + 8 (q >> 1),
  // column 8j + 2t + (q & 1)); C[r, k] goes to dw[k, r]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + wg * 64 + (warp & 3) * 16 + gq + 8 * half;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < CG_BK / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = kb0 + j * 8 + 2 * t + q;
        if (k < K) dst[(int64_t)k * R + r] = acc[4 * j + 2 * half + q];
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

// 32-bit words of the G stage images at these shapes (the gimg argument)
extern "C" long long cin_weight_grad_gimg_words(int B, int D, int K) {
  if (B < 0 || D <= 0 || K <= 0) return 0;
  const long long N = (long long)B * D;
  const long long stages = N > 0 ? (N + CG_SN - 1) / CG_SN : 1;
  return stages * ((K + CG_BK - 1) / CG_BK) * 2 * CG_GWORDS;
}

// g/x1/x0 float32; out [K, H, M] float32; the contraction cut into
// `splits` slices of ceil(stages / splits) stages of 24 n (splits as
// `cin_fuse.cin_grad_splits` chose it: no slice empty); work splits * K *
// H * M floats where splits > 1; gimg cin_weight_grad_gimg_words(B, D, K)
// words.
extern "C" int cin_weight_grad_launch(const void* g, const void* x1,
                                      const void* x0, void* out, void* work,
                                      void* gimg, int B, int H, int M, int D,
                                      int K, int splits, void* stream) {
  if (H <= 0 || M <= 0 || K <= 0) return 0;
  if (B < 0 || D <= 0 || splits < 1 || splits > CG_MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int64_t N = (int64_t)B * D;
  const int64_t stages = N > 0 ? (N + CG_SN - 1) / CG_SN : 1;
  const int64_t per = (stages + splits - 1) / splits;
  if ((stages + per - 1) / per != splits ||
      (int64_t)H * M > INT32_MAX - CG_BM ||
      (K + CG_BK - 1) / CG_BK > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * cg_smem_words(H, M);
  int err;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if ((err = (int)cudaFuncSetAttribute(
           cin_weight_grad_kernel,
           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int R = H * M;
  const int kblocks = (K + CG_BK - 1) / CG_BK;
  const int64_t tasks = stages * kblocks * CG_BK * (CG_SN / 4);
  const int64_t iblocks = (tasks + 255) / 256;
  cin_grad_g_image_kernel<<<(unsigned)(iblocks < 16384 ? iblocks : 16384),
                            256, 0, st>>>((const float*)g, (uint32_t*)gimg,
                                          B, D, K, stages, kblocks);
  if ((err = (int)cudaGetLastError())) return err;
  const dim3 grid((unsigned)((R + CG_BM - 1) / CG_BM), (unsigned)kblocks,
                  (unsigned)splits);
  cin_weight_grad_kernel<<<grid, CG_THREADS, smem, st>>>(
      (const uint32_t*)gimg, (const float*)x1, (const float*)x0,
      splits > 1 ? (float*)work : (float*)out, B, H, M, D, K,
      cg_nh(H, M) + cg_nm(M), per * CG_SN);
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

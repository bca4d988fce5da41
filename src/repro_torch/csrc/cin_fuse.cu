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
// 200, M = 39, D = 10) that is ~7,800 FLOP per byte moved, far above the
// card's 67 TFLOP/s fp32 (outside the tensor cores, H100 SXM data sheet)
// over 3.35 TB/s = 20 FLOP per byte. So the work is an fp32 FMA stream,
// and the kernel's job is to keep the FMA units fed from registers.
//
// Design. The TPU kernel forms the outer product z[b, h, m, d] of a batch
// tile in VMEM and contracts it with w as one matmul [bB*D, H*M] x
// [H*M, K]. Here the same product is read as a GEMM
//   C[k, n] = sum_{h, m} w[k, h, m] * x1[b, h, d] * x0[b, m, d],
//   n = b*D + d (the batch and embedding axes flattened),
// whose right operand z is never stored anywhere: each thread forms the
// four z values it needs in registers from x1 and x0.
//  * A block owns a 40 (k) x 128 (n) output tile: 5 warps, each warp 8
//    rows of k, each lane 4 consecutive columns n, so a thread keeps an
//    8 x 4 tile of fp32 accumulators in registers. 40 divides the model's
//    K = 200; rows past K (other K) are masked.
//  * x0 of the block's 128 columns ([M, 128], 20 KB at M = 39) is staged
//    in shared memory once. w[k, h, :] and x1[:, h, d] are staged for 4
//    values of h at a time ([4, M, 40] and [4, 128]); each k row of w
//    contributes one contiguous run of 4*M floats, read coalesced (the
//    largest w, 6.24 MB, stays in the 50 MB L2 across blocks).
//  * Inner step, per (h, m): one 16-byte load of x0 (lanes contiguous),
//    two 16-byte loads of w (the same address across the warp: a
//    broadcast), four multiplies z = x1 * x0, 32 FMAs.
//  * Any B is taken: the last column tile masks n >= B*D (the TPU
//    wrapper padded B to a multiple of 8 instead).
// Not used yet: wgmma, TMA, and a TF32 or bf16 tensor-core path; those
// change the rounding and wait for their own tolerance decision.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CIN_TK 8                      // k rows per warp
#define CIN_TN 4                      // n columns per lane
#define CIN_WARPS 5
#define CIN_BK (CIN_WARPS * CIN_TK)   // 40 k rows per block
#define CIN_BN (32 * CIN_TN)          // 128 n columns per block
#define CIN_HB 4                      // h values per shared-memory stage
#define CIN_THREADS (CIN_WARPS * 32)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(CIN_THREADS)
    cin_layer_kernel(const T* __restrict__ x1, const T* __restrict__ x0,
                     const T* __restrict__ w, float* __restrict__ out, int B,
                     int H, int M, int D, int K) {
  extern __shared__ float4 smem4[];
  float* x0s = reinterpret_cast<float*>(smem4);  // [M][BN]
  float* x1s = x0s + M * CIN_BN;                 // [HB][BN]
  float* ws = x1s + CIN_HB * CIN_BN;             // [HB * M][BK]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t N = (int64_t)B * D;
  const int64_t n0 = (int64_t)blockIdx.x * CIN_BN;
  const int k0 = blockIdx.y * CIN_BK;

  for (int i = tid; i < M * CIN_BN; i += CIN_THREADS) {
    const int m = i / CIN_BN;
    const int64_t n = n0 + (i % CIN_BN);
    float v = 0.f;
    if (n < N) v = to_f32(x0[((n / D) * M + m) * D + n % D]);
    x0s[i] = v;
  }

  float acc[CIN_TK][CIN_TN];
#pragma unroll
  for (int i = 0; i < CIN_TK; ++i)
#pragma unroll
    for (int j = 0; j < CIN_TN; ++j) acc[i][j] = 0.f;

  for (int h0 = 0; h0 < H; h0 += CIN_HB) {
    const int hb = min(CIN_HB, H - h0);
    __syncthreads();  // the previous stage is consumed
    for (int i = tid; i < hb * CIN_BN; i += CIN_THREADS) {
      const int hh = i / CIN_BN;
      const int64_t n = n0 + (i % CIN_BN);
      float v = 0.f;
      if (n < N) v = to_f32(x1[((n / D) * H + h0 + hh) * D + n % D]);
      x1s[i] = v;
    }
    // w[k, h0 .. h0 + hb, :] is one contiguous run of hb*M per k row
    const int run = hb * M;
    for (int kk = warp; kk < CIN_BK; kk += CIN_WARPS) {
      const int k = k0 + kk;
      const T* src = w + ((int64_t)k * H + h0) * M;
      for (int r = lane; r < run; r += 32)
        ws[r * CIN_BK + kk] = k < K ? to_f32(src[r]) : 0.f;
    }
    __syncthreads();
    for (int hh = 0; hh < hb; ++hh) {
      const float4 a =
          *reinterpret_cast<const float4*>(x1s + hh * CIN_BN + lane * CIN_TN);
      const float* wrow = ws + hh * M * CIN_BK + warp * CIN_TK;
      for (int m = 0; m < M; ++m) {
        const float4 b =
            *reinterpret_cast<const float4*>(x0s + m * CIN_BN + lane * CIN_TN);
        const float z[CIN_TN] = {a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w};
        const float4 wa = *reinterpret_cast<const float4*>(wrow + m * CIN_BK);
        const float4 wb =
            *reinterpret_cast<const float4*>(wrow + m * CIN_BK + 4);
        const float wv[CIN_TK] = {wa.x, wa.y, wa.z, wa.w,
                                  wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < CIN_TK; ++i)
#pragma unroll
          for (int j = 0; j < CIN_TN; ++j)
            acc[i][j] = fmaf(wv[i], z[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < CIN_TK; ++i) {
    const int k = k0 + warp * CIN_TK + i;
    if (k >= K) break;
#pragma unroll
    for (int j = 0; j < CIN_TN; ++j) {
      const int64_t n = n0 + lane * CIN_TN + j;
      if (n < N) out[((n / D) * K + k) * D + n % D] = acc[i][j];
    }
  }
}

static const size_t kMaxSmem = 232448;  // 227 KB, a block's most on sm_90

template <typename T>
static int launch(const void* x1, const void* x0, const void* w, void* out,
                  int B, int H, int M, int D, int K, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)M * CIN_BN + CIN_HB * CIN_BN +
                       (size_t)CIN_HB * M * CIN_BK);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cin_layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t N = (int64_t)B * D;
  const dim3 grid((unsigned)((N + CIN_BN - 1) / CIN_BN),
                  (unsigned)((K + CIN_BK - 1) / CIN_BK));
  cin_layer_kernel<T><<<grid, CIN_THREADS, smem, stream>>>(
      (const T*)x1, (const T*)x0, (const T*)w, (float*)out, B, H, M, D, K);
  return (int)cudaGetLastError();
}

// x1/x0/w float32 (bf16 == 0) or bfloat16 (bf16 == 1); out float32.
extern "C" int cin_layer_launch(const void* x1, const void* x0,
                                const void* w, void* out, int B, int H,
                                int M, int D, int K, int bf16,
                                void* stream) {
  if (B <= 0 || D <= 0 || K <= 0) return 0;
  if (H < 0 || M < 0) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * D > (int64_t)INT32_MAX * CIN_BN ||
      K > 65535 * CIN_BK)
    return (int)cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat16>(x1, x0, w, out, B, H, M, D, K,
                                      (cudaStream_t)stream)
              : launch<float>(x1, x0, w, out, B, H, M, D, K,
                              (cudaStream_t)stream);
}

// Fused 2x2-stride-2 transposed convolution + channel concat with the skip:
//
//   out[b, 2h+dy, 2w+dx, :Cs] = skip[b, 2h+dy, 2w+dx, :]
//   out[b, 2h+dy, 2w+dx, Cs:] = x[b, h, w, :] · Wv[:, dy, dx, :] + bias
//
// x (B, H, W, Cin), skip (B, 2H, 2W, Cs) and out (B, 2H, 2W, Cs+Co) are
// NHWC; Wv (Cin, 2, 2, Co) is the NHWC view of the torch ConvTranspose2d
// weight (Cin, Co, 2, 2) in channels_last memory, so Wv[i, dy, dx, c] =
// W_t[i, c, dy, dx] (= k[1-dy, 1-dx, i, c] in the flax layout).
//
// Replaces: segtpu/kernels/fused_conv.py::upsample2x_concat_pallas (Pallas,
// TPU), which ran the four taps as four (th·tw, Cin) x (Cin, Co) matmuls per
// grid step and interleaved them in VMEM.
//
// Here the four taps are one GEMM: X (M = B·H·W, Cin) x Wv (Cin, 4·Co),
// because Wv's rows are already [tap][c] in memory. Column n of the product
// is tap n / Co and channel n % Co; the epilogue scatters each column to
// its output pixel, so the upsampled tensor and the concat never exist as
// separate passes. The skip copy is spread over all blocks of the grid.
//
// What bounds it on an H100: 2·Cin·4·Co flops per input pixel against
// Cin + 4·(Cs + Cs + Co) elements moved; at the flagship decoder shapes
// (Cin 256/128, Co 128/64, Cs = Co) that is 37..73 flops per bf16 byte, below
// the tensor cores' ridge, so the least time is set by bytes. This first
// version runs the product on the CUDA cores in f32 (4x4 register tile per
// thread), where it is bound by FMA issue instead. Moving it to mma/wgmma
// is later work.
//
// Numerics: products and sums in f32, bias (f32) added in f32, result
// rounded to the output type, skip copied bit for bit.

#include "common.cuh"

namespace {

using segtpu::from_f32;
using segtpu::to_f32;

constexpr int kTM = 64;       // input pixels per block
constexpr int kTN = 64;       // GEMM columns (tap, channel) per block
constexpr int kKC = 32;       // reduction chunk over Cin
constexpr int kThreads = 256; // thread t: columns 4·(t%16)..+3, pixels t/16 + 16·i

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2x_concat_kernel(const T* __restrict__ x, const T* __restrict__ wv,
                         const float* __restrict__ bias,
                         const T* __restrict__ skip, T* __restrict__ out,
                         int batch, int h, int w, int cin, int co, int cs) {
  __shared__ float a_s[kKC][kTM + 1];
  __shared__ __align__(16) float w_s[kKC][kTN];

  const int tid = threadIdx.x;
  const int tn = tid % 16;
  const int tp = tid / 16;
  const long long m = static_cast<long long>(batch) * h * w;
  const long long p0 = static_cast<long long>(blockIdx.x) * kTM;
  const int n0 = blockIdx.y * kTN;
  const int ncols = 4 * co;
  const int ctot = cs + co;
  const int oh = 2 * h, ow = 2 * w;

  // skip copy for the 4·kTM output pixels of this pixel tile, shared by the
  // gridDim.y blocks that work on the tile
  {
    const long long work = static_cast<long long>(kTM) * 4 * cs;
    for (long long e = tid + static_cast<long long>(blockIdx.y) * kThreads;
         e < work; e += static_cast<long long>(kThreads) * gridDim.y) {
      const int c = static_cast<int>(e % cs);
      const int tap = static_cast<int>((e / cs) % 4);
      const long long p = p0 + e / (4LL * cs);
      if (p >= m) continue;
      const long long b = p / (static_cast<long long>(h) * w);
      const int hh = static_cast<int>((p / w) % h), ww = static_cast<int>(p % w);
      const long long q =
          (b * oh + 2 * hh + tap / 2) * ow + 2 * ww + tap % 2;
      out[q * ctot + c] = skip[q * cs + c];
    }
  }

  float acc[4][4] = {};
  for (int k0 = 0; k0 < cin; k0 += kKC) {
    for (int e = tid; e < kTM * kKC; e += kThreads) {
      const int pp = e / kKC, kk = e % kKC;
      const long long p = p0 + pp;
      const int k = k0 + kk;
      a_s[kk][pp] = (p < m && k < cin) ? to_f32(x[p * cin + k]) : 0.f;
    }
    for (int e = tid; e < kKC * kTN; e += kThreads) {
      const int kk = e / kTN, nn = e % kTN;
      const int k = k0 + kk, n = n0 + nn;
      w_s[kk][nn] = (k < cin && n < ncols)
                        ? to_f32(wv[static_cast<long long>(k) * ncols + n])
                        : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      const float4 w4 = *reinterpret_cast<const float4*>(&w_s[kk][tn * 4]);
      const float wr[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = a_s[kk][tp + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wr[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + tp + 16 * i;
    if (p >= m) continue;
    const long long b = p / (static_cast<long long>(h) * w);
    const int hh = static_cast<int>((p / w) % h), ww = static_cast<int>(p % w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n >= ncols) continue;
      const int tap = n / co, c = n % co;
      const long long q = (b * oh + 2 * hh + tap / 2) * ow + 2 * ww + tap % 2;
      out[q * ctot + cs + c] = from_f32<T>(acc[i][j] + bias[c]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* wv, const void* bias, const void* skip,
            void* out, int batch, int h, int w, int cin, int co, int cs,
            cudaStream_t stream) {
  const long long m = static_cast<long long>(batch) * h * w;
  const dim3 grid(static_cast<unsigned>((m + kTM - 1) / kTM),
                  static_cast<unsigned>((4 * co + kTN - 1) / kTN));
  upsample2x_concat_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wv),
      static_cast<const float*>(bias), static_cast<const T*>(skip),
      static_cast<T*>(out), batch, h, w, cin, co, cs);
}

}  // namespace

extern "C" int upsample2x_concat_launch(int dtype, const void* x,
                                        const void* wv, const void* bias,
                                        const void* skip, void* out, int batch,
                                        int h, int w, int cin, int co, int cs,
                                        void* stream) {
  if (static_cast<long long>(batch) * h * w <= 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == segtpu::kFloat32)
    launch<float>(x, wv, bias, skip, out, batch, h, w, cin, co, cs, s);
  else if (dtype == segtpu::kBFloat16)
    launch<__nv_bfloat16>(x, wv, bias, skip, out, batch, h, w, cin, co, cs, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* upsample2x_concat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

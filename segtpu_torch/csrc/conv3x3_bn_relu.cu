// Fused 3x3 'same' convolution (stride 1, zero padding 1) + per-channel
// scale/bias (inference BatchNorm folded by the caller) + ReLU:
//
//   out[b, y, x, n] = relu(scale[n] · Σ_{dy,dx,k} xpad[b, y+dy, x+dx, k]
//                                         · w[dy, dx, k, n] + bias[n])
//
// x (B, H, W, Cin) and out (B, H, W, Cout) are NHWC; w (3, 3, Cin, Cout)
// is HWIO, the JAX layout; scale and bias are f32 (Cout,).
//
// Replaces: segtpu/kernels/fused_conv.py::conv3x3_bn_relu_pallas (Pallas,
// TPU), which padded x in device memory (jnp.pad, a whole extra pass over
// the input), DMA'd a (tile+2)² window per grid step into VMEM and ran nine
// shifted (tile², Cin) x (Cin, Cout) matmuls.
//
// Here the conv is an implicit GEMM: M = B·H·W output pixels, N = Cout,
// K = 9·Cin. A block owns a tile of TM flat pixels x TN channels and walks
// K tap by tap, Cin in chunks of kKC. For tap (dy, dx) the A tile is the
// input at the block's pixels shifted by (dy-1, dx-1), read straight from
// x with a bounds test per pixel: the zero halo is those failed tests, so
// no padded copy of x exists. Flat pixel tiles make the ragged edge (H, W
// not multiples of anything) a single p < M test. The scale/bias/ReLU
// epilogue runs on the f32 sums in registers, and out is written once.
//
// What bounds it on an H100: the function's 2·M·9·Cin·Cout operations over
// (M·Cin + 9·Cin·Cout + M·Cout) elements; at the flagship decoder shapes
// (Cin 96..512, Cout 32..256) that is 190..1400 flops per bf16 byte, at or
// above the tensor cores' ridge (~295), so the least time is mostly set by
// operations at the bf16 tensor-core rate. This first version runs the
// product on the CUDA cores in f32 (4x4 register tile per thread), where it
// is bound by FMA issue and shared-memory reads instead, and re-reads each
// input pixel once per tap (from L2). Tensor-core products (mma.sync, then
// wgmma/TMA) and a haloed spatial tile are later work.
//
// Numerics: products and sums in f32, then ·scale + bias in f32, ReLU, and
// one rounding to the output type, as the JAX kernel does.

#include "common.cuh"

namespace {

using segtpu::from_f32;
using segtpu::to_f32;

constexpr int kKC = 32;       // input channels per reduction chunk
constexpr int kThreads = 256;

// TN output channels per block, 4 per thread: TN/4 thread columns, and
// 256/(TN/4) thread rows of 4 pixels each. TN = 32 for Cout <= 32 keeps
// every thread on real channels at the thin decoder level.
template <typename T, int TN>
__global__ void __launch_bounds__(kThreads)
conv3x3_bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out,
                       int batch, int h, int wd, int cin, int cout) {
  constexpr int TC = TN / 4;            // thread columns
  constexpr int TR = kThreads / TC;     // thread rows
  constexpr int TM = 4 * TR;            // pixels per block
  constexpr int kStage = TM * kKC / kThreads;  // A elements staged per thread
  __shared__ float a_s[kKC][TM + 1];
  __shared__ __align__(16) float w_s[kKC][TN];

  const int tid = threadIdx.x;
  const int tn = tid % TC;
  const int tp = tid / TC;
  const long long m = static_cast<long long>(batch) * h * wd;
  const long long p0 = static_cast<long long>(blockIdx.x) * TM;
  const int n0 = blockIdx.y * TN;

  // The A elements this thread stages: channel kk of pixels
  // pp = tid / kKC + r · (kThreads / kKC). Their (y, x) are fixed for the
  // whole K walk; y = -4 marks a pixel past the end (every tap fails).
  const int kk_st = tid % kKC;
  int sy[kStage], sx[kStage];
#pragma unroll
  for (int r = 0; r < kStage; ++r) {
    const long long p = p0 + tid / kKC + r * (kThreads / kKC);
    sy[r] = p < m ? static_cast<int>((p / wd) % h) : -4;
    sx[r] = static_cast<int>(p % wd);
  }

  float acc[4][4] = {};
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const long long shift = static_cast<long long>(dy) * wd + dx;
    for (int k0 = 0; k0 < cin; k0 += kKC) {
      const int k = k0 + kk_st;
#pragma unroll
      for (int r = 0; r < kStage; ++r) {
        const int pp = tid / kKC + r * (kThreads / kKC);
        const int y = sy[r] + dy, xx = sx[r] + dx;
        const bool in = k < cin && y >= 0 && y < h && xx >= 0 && xx < wd;
        a_s[kk_st][pp] = in ? to_f32(x[(p0 + pp + shift) * cin + k]) : 0.f;
      }
      for (int e = tid; e < kKC * TN; e += kThreads) {
        const int kk = e / TN, nn = e % TN;
        const int kw = k0 + kk, n = n0 + nn;
        w_s[kk][nn] =
            (kw < cin && n < cout)
                ? to_f32(w[(static_cast<long long>(tap) * cin + kw) * cout + n])
                : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const float4 w4 = *reinterpret_cast<const float4*>(&w_s[kk][tn * 4]);
        const float wr[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = a_s[kk][tp + TR * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wr[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + tp + TR * i;
    if (p >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n >= cout) continue;
      out[p * cout + n] =
          from_f32<T>(fmaxf(acc[i][j] * scale[n] + bias[n], 0.f));
    }
  }
}

template <typename T, int TN>
void launch(const void* x, const void* w, const void* scale, const void* bias,
            void* out, int batch, int h, int wd, int cin, int cout,
            cudaStream_t stream) {
  constexpr int TM = 4 * kThreads / (TN / 4);
  const long long m = static_cast<long long>(batch) * h * wd;
  const dim3 grid(static_cast<unsigned>((m + TM - 1) / TM),
                  static_cast<unsigned>((cout + TN - 1) / TN));
  conv3x3_bn_relu_kernel<T, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), batch, h, wd, cin, cout);
}

template <typename T>
void launch_for_width(const void* x, const void* w, const void* scale,
                      const void* bias, void* out, int batch, int h, int wd,
                      int cin, int cout, cudaStream_t stream) {
  if (cout <= 32)
    launch<T, 32>(x, w, scale, bias, out, batch, h, wd, cin, cout, stream);
  else
    launch<T, 64>(x, w, scale, bias, out, batch, h, wd, cin, cout, stream);
}

}  // namespace

extern "C" int conv3x3_bn_relu_launch(int dtype, const void* x, const void* w,
                                      const void* scale, const void* bias,
                                      void* out, int batch, int h, int wd,
                                      int cin, int cout, void* stream) {
  if (static_cast<long long>(batch) * h * wd <= 0 || cout <= 0)
    return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == segtpu::kFloat32)
    launch_for_width<float>(x, w, scale, bias, out, batch, h, wd, cin, cout, s);
  else if (dtype == segtpu::kBFloat16)
    launch_for_width<__nv_bfloat16>(x, w, scale, bias, out, batch, h, wd, cin,
                                    cout, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv3x3_bn_relu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Fused additive attention gate, inference path:
//
//   out[p, :] = x[p, :] * sigmoid( sum_f relu(g[p]·Ag[:, f] + x[p]·Ax[:, f] + bh[f]) * apsi[f] + bpsi )
//
// over the M = B·H·W pixel rows of the NHWC tensors g (M, Cg) and x (M, Cx).
// The three inference BatchNorms are folded into (Ag, Ax, bh, apsi, bpsi) by
// the caller (segtpu_torch/models/attention.py).
//
// Replaces: segtpu/kernels/attention_gate.py::attention_gate_fused (Pallas,
// TPU). The TPU kernel packed P pixels into the 128-lane dimension and used
// block-diagonal weights; that is a TPU layout device and is not carried
// over. This kernel tiles NHWC pixel rows directly and masks the ragged edge.
//
// What bounds it on an H100: per pixel the gate does 2·F·(Cg+Cx) flops and
// moves Cg + 2·Cx elements. At the flagship shapes (F = 32..128, Cg ≈ Cx)
// that is 21..85 flops per bf16 byte, below the tensor cores' ridge of ~295,
// so the least time is set by bytes: read g and x once, write out once.
// This first version runs the two products on the CUDA cores in f32
// (register-tiled, 4x4 outputs per thread), where the ridge is ~20 flops
// per byte, so it is bound by FMA issue and shared-memory reads instead.
// Its design keeps the traffic at the floor all the same: g and x come from
// device memory once (later F-chunks re-read them from L2), the hidden map
// h never leaves the block, and out is written once. Moving the products to
// mma/wgmma is later work.
//
// Numerics: products and sums in f32, h and alpha kept in f32 (the Pallas
// kernel rounds both to the model dtype in bf16), out rounded to x's type.

#include "common.cuh"

namespace {

using segtpu::from_f32;
using segtpu::to_f32;

constexpr int kTM = 128;      // pixels per block
constexpr int kTF = 32;       // hidden columns per pass over F
constexpr int kKC = 32;       // reduction chunk over Cg + Cx
constexpr int kThreads = 256; // 8 warps: warp w owns columns 4w..4w+3 of a pass,
                              // lane l owns pixels l, l+32, l+64, l+96

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_gate_kernel(const T* __restrict__ g, const T* __restrict__ x,
                      const T* __restrict__ ag, const T* __restrict__ ax,
                      const float* __restrict__ bh, const T* __restrict__ apsi,
                      const float* __restrict__ bpsi, T* __restrict__ out,
                      long long m, int cg, int cx, int f) {
  __shared__ float a_s[kKC][kTM + 1];        // [g | x] chunk, k-major
  __shared__ __align__(16) float w_s[kKC][kTF];  // [Ag ; Ax] chunk
  __shared__ float psi_s[kThreads / 32][kTM];    // psi partial per warp
  __shared__ float alpha_s[kTM];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const long long p0 = static_cast<long long>(blockIdx.x) * kTM;
  const int k_total = cg + cx;

  float psi_acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int f0 = 0; f0 < f; f0 += kTF) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < k_total; k0 += kKC) {
      // stage the input chunk: a warp reads 32 consecutive k of one pixel
      for (int e = tid; e < kTM * kKC; e += kThreads) {
        const int pp = e / kKC, kk = e % kKC;
        const long long p = p0 + pp;
        const int k = k0 + kk;
        float v = 0.f;
        if (p < m && k < k_total)
          v = k < cg ? to_f32(g[p * cg + k]) : to_f32(x[p * cx + (k - cg)]);
        a_s[kk][pp] = v;
      }
      // stage the weight chunk (rows of Ag then Ax; columns f0..f0+kTF)
      for (int e = tid; e < kKC * kTF; e += kThreads) {
        const int kk = e / kTF, ff = e % kTF;
        const int k = k0 + kk, col = f0 + ff;
        float v = 0.f;
        if (k < k_total && col < f)
          v = k < cg ? to_f32(ag[static_cast<long long>(k) * f + col])
                     : to_f32(ax[static_cast<long long>(k - cg) * f + col]);
        w_s[kk][ff] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const float4 w4 = *reinterpret_cast<const float4*>(&w_s[kk][warp * 4]);
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = a_s[kk][lane + 32 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
    // relu(h + bh) · apsi, summed over this thread's 4 columns
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = f0 + warp * 4 + j;
      if (col < f) {
        const float b = bh[col];
        const float ap = to_f32(apsi[col]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          psi_acc[i] = fmaf(fmaxf(acc[i][j] + b, 0.f), ap, psi_acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) psi_s[warp][lane + 32 * i] = psi_acc[i];
  __syncthreads();
  if (tid < kTM) {
    float s = bpsi[0];
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += psi_s[w][tid];
    alpha_s[tid] = 1.f / (1.f + expf(-s));
  }
  __syncthreads();
  // out = x · alpha, coalesced over channels
  for (long long e = tid; e < static_cast<long long>(kTM) * cx; e += kThreads) {
    const int pp = static_cast<int>(e / cx);
    const int c = static_cast<int>(e % cx);
    const long long p = p0 + pp;
    if (p < m) out[p * cx + c] = from_f32<T>(to_f32(x[p * cx + c]) * alpha_s[pp]);
  }
}

template <typename T>
void launch(const void* g, const void* x, const void* ag, const void* ax,
            const void* bh, const void* apsi, const void* bpsi, void* out,
            long long m, int cg, int cx, int f, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((m + kTM - 1) / kTM);
  attention_gate_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const T*>(ag), static_cast<const T*>(ax),
      static_cast<const float*>(bh), static_cast<const T*>(apsi),
      static_cast<const float*>(bpsi), static_cast<T*>(out), m, cg, cx, f);
}

}  // namespace

extern "C" int attention_gate_launch(int dtype, const void* g, const void* x,
                                     const void* ag, const void* ax,
                                     const void* bh, const void* apsi,
                                     const void* bpsi, void* out, long long m,
                                     int cg, int cx, int f, void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == segtpu::kFloat32)
    launch<float>(g, x, ag, ax, bh, apsi, bpsi, out, m, cg, cx, f, s);
  else if (dtype == segtpu::kBFloat16)
    launch<__nv_bfloat16>(g, x, ag, ax, bh, apsi, bpsi, out, m, cg, cx, f, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* attention_gate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

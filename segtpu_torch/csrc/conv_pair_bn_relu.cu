// The decoder block at inference, [3x3 'same' conv -> ·scale + bias -> ReLU]
// twice, in one launch, with the intermediate kept in shared memory:
//
//   mid = round_T(relu(conv3x3(x,   w1) · s1 + b1))   (zero outside the image)
//   out = round_T(relu(conv3x3(mid, w2) · s2 + b2))
//
// x (B, H, W, Cin), out (B, H, W, C) NHWC; w1 (3, 3, Cin, C) and
// w2 (3, 3, C, C) HWIO; s1, b1, s2, b2 f32 (C,). T is the I/O type, f32 or
// bf16; the intermediate is rounded to T before conv 2, as the reference
// does.
//
// Replaces: segtpu/kernels/fused_block.py::conv_pair_bn_relu_pallas
// (Pallas, TPU). That kernel cut x into overlapping (t+4)² tiles in device
// memory (_extract_tiles, a copy of the whole input) and read a
// precomputed in-image mask tensor, both devices to get past the TPU's
// remote compiler. Neither exists here: the block reads its haloed window
// from x itself with bounds tests (zeros outside the image), and takes the
// in-image test for the intermediate from its own tile index.
//
// Design: a block owns one kT x kT output tile of one image, all C output
// channels.
//   1. conv 1 over the (kT+2)² intermediate window: an implicit GEMM with
//      M1 = (kT+2)² pixels, N = C in chunks of NC, K = 9·Cin. The
//      (kT+4)² input window is streamed through shared memory kKC input
//      channels at a time (once per chunk of NC output channels), w1 the
//      same. The epilogue applies s1/b1/ReLU, writes zero at pixels outside
//      the image (conv 2 must see the 'same' padding there), rounds to T and
//      stores into the shared intermediate.
//   2. conv 2 from the shared intermediate: M2 = kT² pixels, N = C in
//      chunks of NC, K = 9·C, w2 streamed as in step 1. The epilogue
//      applies s2/b2/ReLU and writes each output element once.
// The intermediate never touches device memory.
//
// Shared memory: the intermediate is (kT+2)²·C elements, which at the
// TPU's tile of 32 and C = 256 would be 592 KB in bf16, against the 227 KB
// a block can have. kT = 8 keeps it at 100·C elements (51 KB bf16, 103 KB
// f32 at C = 256); with the staging buffers a block needs
// 46 KB + 100·(C+pad)·sizeof(T), which the wrapper checks against the
// limit. The price is the halo: conv 1 is computed on (kT+2)²/kT² = 1.56x
// the output pixels.
//
// What bounds it on an H100: the function's work is 2·M·9·C·(Cin + C)
// operations over (M·Cin + 9·C·(Cin + C) + M·C) elements; at the flagship
// decoder shapes that is operations at the bf16 tensor-core rate for
// levels 4..2 and bytes at level 1 (256², Cin 96, C 32). This first
// version runs both products on the CUDA cores in f32 (4 channels x up to
// 7 pixels per thread), bound by FMA issue and shared-memory reads, plus
// the 1.56x halo recompute of conv 1. Tensor-core products and a larger
// tile (fewer halo pixels) are later work.

#include "common.cuh"

namespace {

using segtpu::from_f32;
using segtpu::to_f32;

constexpr int kT = 8;               // output tile side
constexpr int kMid = kT + 2;        // intermediate window side
constexpr int kIn = kT + 4;         // input window side
constexpr int kM1 = kMid * kMid;    // intermediate pixels per block
constexpr int kM2 = kT * kT;        // output pixels per block
constexpr int kKC = 16;             // reduction channels per chunk
constexpr int kInStride = kKC + 1;  // padded: neighbouring pixels, other banks
constexpr int kThreads = 256;

// Shared bytes for NC output channels per chunk and C channels of type T;
// mirrored by segtpu_torch/kernels/fused_block.py::_smem_bytes.
template <typename T, int NC>
constexpr long long smem_bytes(int c) {
  return 4LL * (kIn * kIn * kInStride + 9 * kKC * NC) +
         static_cast<long long>(kM1) * (c + 4 / sizeof(T)) * sizeof(T);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
conv_pair_bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                         const float* __restrict__ s1,
                         const float* __restrict__ b1,
                         const T* __restrict__ w2,
                         const float* __restrict__ s2,
                         const float* __restrict__ b2, T* __restrict__ out,
                         int h, int wd, int cin, int c) {
  constexpr int TC = NC / 4;                  // thread columns, 4 channels each
  constexpr int TR = kThreads / TC;           // thread rows
  constexpr int R1 = (kM1 + TR - 1) / TR;     // intermediate pixels per thread
  constexpr int R2 = kM2 / TR;                // output pixels per thread
  static_assert(kM2 % TR == 0, "output tile must split over thread rows");
  // padded row of the intermediate: an odd number of 4-byte words, so the
  // thread rows of a warp read other banks
  const int mid_stride = c + 4 / static_cast<int>(sizeof(T));

  extern __shared__ __align__(16) unsigned char smem[];
  float* in_s = reinterpret_cast<float*>(smem);          // [kIn²][kInStride]
  float* w_s = in_s + kIn * kIn * kInStride;             // [9][kKC][NC]
  T* mid_s = reinterpret_cast<T*>(w_s + 9 * kKC * NC);   // [kM1][mid_stride]

  const int tiles_x = (wd + kT - 1) / kT;
  const int ty0 = (blockIdx.x / tiles_x) * kT;
  const int tx0 = (blockIdx.x % tiles_x) * kT;
  const long long img = static_cast<long long>(blockIdx.y) * h;
  const int tid = threadIdx.x;
  const int tn = tid % TC;
  const int tr = tid / TC;

  // ---- conv 1: (kT+2)² intermediate pixels, all C channels
  // Pixel p of the intermediate window reads the input window from
  // (p / kMid, p % kMid); rows past kM1 compute on pixel 0 and are dropped.
  int off1[R1];
#pragma unroll
  for (int i = 0; i < R1; ++i) {
    const int p = tr + TR * i;
    off1[i] = p < kM1 ? (p / kMid) * kIn + p % kMid : 0;
  }
  for (int n0 = 0; n0 < c; n0 += NC) {
    float acc[R1][4] = {};
    for (int k0 = 0; k0 < cin; k0 += kKC) {
      for (int e = tid; e < kIn * kIn * kKC; e += kThreads) {
        const int pix = e / kKC, kk = e % kKC, k = k0 + kk;
        const int gy = ty0 - 2 + pix / kIn, gx = tx0 - 2 + pix % kIn;
        const bool in = k < cin && gy >= 0 && gy < h && gx >= 0 && gx < wd;
        in_s[pix * kInStride + kk] =
            in ? to_f32(x[((img + gy) * wd + gx) * cin + k]) : 0.f;
      }
      for (int e = tid; e < 9 * kKC * NC; e += kThreads) {
        const int tap = e / (kKC * NC), kk = (e / NC) % kKC, nn = e % NC;
        const int k = k0 + kk, n = n0 + nn;
        w_s[e] = (k < cin && n < c)
                     ? to_f32(w1[(static_cast<long long>(tap) * cin + k) * c + n])
                     : 0.f;
      }
      __syncthreads();
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3) * kIn + tap % 3;
#pragma unroll 4
        for (int kk = 0; kk < kKC; ++kk) {
          const float4 w4 = *reinterpret_cast<const float4*>(
              &w_s[(tap * kKC + kk) * NC + tn * 4]);
          const float wr[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int i = 0; i < R1; ++i) {
            const float a = in_s[(off1[i] + toff) * kInStride + kk];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wr[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < R1; ++i) {
      const int p = tr + TR * i;
      if (p >= kM1) continue;
      const int gy = ty0 - 1 + p / kMid, gx = tx0 - 1 + p % kMid;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tn * 4 + j;
        if (n >= c) continue;
        const float v = inside ? fmaxf(acc[i][j] * s1[n] + b1[n], 0.f) : 0.f;
        mid_s[p * mid_stride + n] = from_f32<T>(v);
      }
    }
  }
  // (the first __syncthreads of conv 2 orders these stores before any read)

  // ---- conv 2: kT² output pixels from the intermediate
  int off2[R2];
#pragma unroll
  for (int i = 0; i < R2; ++i) {
    const int p = tr + TR * i;
    off2[i] = (p / kT) * kMid + p % kT;
  }
  for (int n0 = 0; n0 < c; n0 += NC) {
    float acc[R2][4] = {};
    for (int k0 = 0; k0 < c; k0 += kKC) {
      for (int e = tid; e < 9 * kKC * NC; e += kThreads) {
        const int tap = e / (kKC * NC), kk = (e / NC) % kKC, nn = e % NC;
        const int k = k0 + kk, n = n0 + nn;
        w_s[e] = (k < c && n < c)
                     ? to_f32(w2[(static_cast<long long>(tap) * c + k) * c + n])
                     : 0.f;
      }
      __syncthreads();
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3) * kMid + tap % 3;
#pragma unroll 4
        for (int kk = 0; kk < kKC; ++kk) {
          // past C the weights are zero; clamp the read inside the row
          const int k = min(k0 + kk, c - 1);
          const float4 w4 = *reinterpret_cast<const float4*>(
              &w_s[(tap * kKC + kk) * NC + tn * 4]);
          const float wr[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int i = 0; i < R2; ++i) {
            const float a = to_f32(mid_s[(off2[i] + toff) * mid_stride + k]);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wr[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < R2; ++i) {
      const int p = tr + TR * i;
      const int oy = ty0 + p / kT, ox = tx0 + p % kT;
      if (oy >= h || ox >= wd) continue;
      T* o = out + ((img + oy) * wd + ox) * c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tn * 4 + j;
        if (n < c) o[n] = from_f32<T>(fmaxf(acc[i][j] * s2[n] + b2[n], 0.f));
      }
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* x, const void* w1, const void* s1,
                   const void* b1, const void* w2, const void* s2,
                   const void* b2, void* out, int batch, int h, int wd,
                   int cin, int c, cudaStream_t stream) {
  const long long smem = smem_bytes<T, NC>(c);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > limit) return cudaErrorInvalidValue;
  auto kernel = conv_pair_bn_relu_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = ((h + kT - 1) / kT) * ((wd + kT - 1) / kT);
  kernel<<<dim3(tiles, batch), kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<T*>(out), h, wd, cin, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_width(const void* x, const void* w1, const void* s1,
                             const void* b1, const void* w2, const void* s2,
                             const void* b2, void* out, int batch, int h,
                             int wd, int cin, int c, cudaStream_t stream) {
  if (c <= 32)
    return launch<T, 32>(x, w1, s1, b1, w2, s2, b2, out, batch, h, wd, cin, c,
                         stream);
  return launch<T, 64>(x, w1, s1, b1, w2, s2, b2, out, batch, h, wd, cin, c,
                       stream);
}

}  // namespace

extern "C" int conv_pair_bn_relu_launch(int dtype, const void* x,
                                        const void* w1, const void* s1,
                                        const void* b1, const void* w2,
                                        const void* s2, const void* b2,
                                        void* out, int batch, int h, int wd,
                                        int cin, int c, void* stream) {
  if (static_cast<long long>(batch) * h * wd <= 0 || c <= 0)
    return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == segtpu::kFloat32)
    err = launch_for_width<float>(x, w1, s1, b1, w2, s2, b2, out, batch, h, wd,
                                  cin, c, s);
  else if (dtype == segtpu::kBFloat16)
    err = launch_for_width<__nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, out, batch,
                                          h, wd, cin, c, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* conv_pair_bn_relu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

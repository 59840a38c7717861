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
// (Cin 256/128, Co 128/64, Cs = Co) that is 37..73 flops per bf16 byte,
// below the tensor cores' ridge (~295), so the least time is set by
// bytes: x and the skip read once, out written once. Most of those bytes
// are the skip (read, then written again into out) and out itself.
//
// bf16 (upsample_bf16_kernel): the GEMM on the tensor cores,
// mma.sync.m16n8k16 with f32 accumulation (conv_mma.cuh). 8.6 GFLOP over
// the two serving levels is 29 us at 30% of the bf16 peak, under the
// 53 us byte bound, so warpgroup wgmma is not needed here. A block owns
// 64 input pixels of the flat M (any W) and 256 of the 4·Co columns; x
// rows and wv rows (already K x N with N contiguous, so no transpose) are
// staged by a 3-deep cp.async ring over Cin in XOR-swizzled chunks. The
// epilogue adds the f32 bias, rounds once, stages the tile in the freed
// ring and writes each pixel's channels of one tap as 16-byte stores; the
// skip is copied with 16-byte streaming loads and stores, four in flight
// per thread, before the product. Per-pixel output addresses are
// computed once per block with one 32-bit division per pixel; nothing
// divides per element. Each x row comes from device memory once (the
// other column blocks of the same pixels, at Co > 64, read it from L2);
// wv is re-read per block from L2. Any Cin, Co and Cs: tails past a
// multiple of 8 are staged with plain loads and stored element by
// element.
//
// Reached (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W power limit; bf16,
// B = 16, CUDA events around each call after a cold-L2 flush): 0.059 and
// 0.111 ms at the two serving levels (3, 2), 0.17 ms in sum against a
// byte bound of 0.053 ms and 0.27 ms for F.conv_transpose2d + torch.cat;
// in a profiled forward its two launches take 0.098 ms of device time.
//
// f32 (upsample2x_concat_kernel): the CUDA-core product of the first
// port (4x4 register tile per thread), kept because TF32 or bf16
// products cannot meet the f32 tolerance (1e-4).
//
// Numerics: products and sums in f32, bias (f32) added in f32, result
// rounded to the output type once, skip copied bit for bit.

#include "common.cuh"
#include "conv_mma.cuh"

namespace {

constexpr int kTM = 64;       // input pixels per block
constexpr int kTN = 64;       // GEMM columns (tap, channel) per block
constexpr int kKC = 32;       // reduction chunk over Cin
constexpr int kThreads = 256; // thread t: columns 4·(t%16)..+3, pixels t/16 + 16·i

__global__ void __launch_bounds__(kThreads)
upsample2x_concat_kernel(const float* __restrict__ x,
                         const float* __restrict__ wv,
                         const float* __restrict__ bias,
                         const float* __restrict__ skip,
                         float* __restrict__ out, int batch, int h, int w,
                         int cin, int co, int cs) {
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
      a_s[kk][pp] = (p < m && k < cin) ? x[p * cin + k] : 0.f;
    }
    for (int e = tid; e < kKC * kTN; e += kThreads) {
      const int kk = e / kTN, nn = e % kTN;
      const int k = k0 + kk, n = n0 + nn;
      w_s[kk][nn] = (k < cin && n < ncols)
                        ? wv[static_cast<long long>(k) * ncols + n]
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
      out[q * ctot + cs + c] = acc[i][j] + bias[c];
    }
  }
}

void launch_f32(const void* x, const void* wv, const void* bias,
                const void* skip, void* out, int batch, int h, int w, int cin,
                int co, int cs, cudaStream_t stream) {
  const long long m = static_cast<long long>(batch) * h * w;
  const dim3 grid(static_cast<unsigned>((m + kTM - 1) / kTM),
                  static_cast<unsigned>((4 * co + kTN - 1) / kTN));
  upsample2x_concat_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wv),
      static_cast<const float*>(bias), static_cast<const float*>(skip),
      static_cast<float*>(out), batch, h, w, cin, co, cs);
}

// ---- bf16: the four taps as one tensor-core GEMM (conv_mma.cuh)

namespace mma = segtpu::mma;
using mma::bf16_bits;

constexpr int kBM = 64;        // input pixels per block
constexpr int kBN = 256;       // GEMM columns (dy, dx, c) per block
constexpr int kBK = 32;        // input channels per pipeline stage
constexpr int kStages = 3;
constexpr int kWarpsN = 4;     // 2 x 4 warps of 32 pixels x 64 columns
constexpr int kBf16Threads = 256;
constexpr int kMT = 2, kNT = 8;  // m16 and n8 tiles per warp
constexpr int kABytes = kBM * kBK * 2;
constexpr int kStageBytes = kABytes + kBK * kBN * 2;
constexpr int kOutStride = kBN + 8;  // bf16 per staged output row
constexpr int kBf16Smem = kStages * kStageBytes > kBM * kOutStride * 2
                              ? kStages * kStageBytes
                              : kBM * kOutStride * 2;
constexpr int kCopyUnroll = 4;   // skip chunks in flight per thread
static_assert(kBN == kBf16Threads, "one bias column per thread");

// The skip's channels of the 4·kBM output pixels of this block's input
// pixels, into channels [0, cs) of out: work item e is (pixel, tap,
// 16-byte chunk), shared by the gridDim.y blocks of the pixel tile.
// pix_q[r]: out pixel index of tap (0, 0) of tile pixel r, -1 past m.
__device__ __forceinline__ void copy_skip(const bf16_bits* __restrict__ skip,
                                          bf16_bits* __restrict__ out,
                                          const long long* pix_q, int ow,
                                          int cs, int ctot, bool vec) {
  const int step = kBf16Threads * gridDim.y;
  const int first = threadIdx.x + kBf16Threads * blockIdx.y;
  if (vec) {
    const int cs8 = cs / 8;
    const int per_pixel = 4 * cs8;
    const int work = kBM * per_pixel;
    for (int e0 = first; e0 < work; e0 += kCopyUnroll * step) {
      uint4 v[kCopyUnroll];
      long long dst[kCopyUnroll];
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int e = e0 + u * step;
        dst[u] = -1;
        if (e >= work) continue;
        const int r = e / per_pixel, rest = e - r * per_pixel;
        const int tap = rest / cs8, c = rest - tap * cs8;
        const long long q0 = pix_q[r];
        if (q0 < 0) continue;
        const long long q = q0 + (tap >> 1) * ow + (tap & 1);
        v[u] = __ldcs(reinterpret_cast<const uint4*>(skip + q * cs) + c);
        dst[u] = q * ctot + 8 * c;
      }
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u)
        if (dst[u] >= 0) *reinterpret_cast<uint4*>(out + dst[u]) = v[u];
    }
  } else {
    const int work = kBM * 4 * cs;
    for (int e = first; e < work; e += step) {
      const int r = e / (4 * cs), rest = e - r * 4 * cs;
      const int tap = rest / cs, c = rest - tap * cs;
      const long long q0 = pix_q[r];
      if (q0 < 0) continue;
      const long long q = q0 + (tap >> 1) * ow + (tap & 1);
      out[q * ctot + c] = skip[q * cs + c];
    }
  }
}

// Block (i, j): input pixels [64i, 64i + 64) of the flat M = B·H·W (any
// W, so narrow rows waste no tile), GEMM columns [256j, 256j + 256) of
// the 4·Co. A (x rows) and B (wv rows, 4·Co contiguous) are staged by a
// 3-deep cp.async ring over Cin; 8 warps of 32 x 64 run mma.sync
// m16n8k16. The epilogue adds the f32 bias, rounds once, stages the tile
// in the ring and stores each pixel's run of 8 channels of one tap as a
// 16-byte store (at Co % 8 == 0 a run never crosses taps). Column
// n = tap·Co + c, tap = 2·dy + dx, goes to output pixel
// (2h + dy, 2w + dx), channel Cs + c.
__global__ void __launch_bounds__(kBf16Threads, 2)
upsample_bf16_kernel(const bf16_bits* __restrict__ x,
                     const bf16_bits* __restrict__ wv,
                     const float* __restrict__ bias,
                     const bf16_bits* __restrict__ skip,
                     bf16_bits* __restrict__ out, int w, int m, int cin,
                     int co, int cs) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long pix_q[kBM];
  __shared__ float bias_s[kBN];
  const std::uint32_t s0 = mma::smem_addr(smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int p0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int ncols = 4 * co, ow = 2 * w, ctot = cs + co;

  if (tid < kBM) {
    const int p = p0 + tid;
    long long q = -1;
    if (p < m) {
      const int r = p / w;  // = b·H + h; output row 2r + dy
      q = 2LL * r * ow + 2 * (p - r * w);
    }
    pix_q[tid] = q;
  }
  {
    const int n = n0 + tid;
    bias_s[tid] = n < ncols ? bias[n % co] : 0.f;
  }
  __syncthreads();
  copy_skip(skip, out, pix_q, ow, cs, ctot,
            cs % 8 == 0 && co % 8 == 0 && mma::aligned16(skip) &&
                mma::aligned16(out));

  const bool vec_x = cin % 8 == 0 && mma::aligned16(x);
  const bool vec_w = ncols % 8 == 0 && mma::aligned16(wv);
  const int nk = (cin + kBK - 1) / kBK;
  auto stage = [&](int kc) {
    const std::uint32_t base = s0 + (kc % kStages) * kStageBytes;
    mma::stage_rows<kBM, kBK / 8, kBf16Threads>(base, x, p0, m, cin, kc * kBK,
                                                cin, vec_x);
    mma::stage_rows<kBK, kBN / 8, kBf16Threads>(base + kABytes, wv, kc * kBK,
                                                cin, ncols, n0, ncols, vec_w);
  };
  // a warp whose 64 columns all lie past 4·Co has nothing to multiply
  const bool active = n0 + 64 * wn < ncols;
  float acc[kMT][kNT][4] = {};
  mma::pipeline<kStages>(nk, stage, [&](int kc) {
    if (!active) return;
    const std::uint32_t a_base = s0 + (kc % kStages) * kStageBytes;
    const std::uint32_t b_base = a_base + kABytes;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      std::uint32_t a[kMT], b[kNT / 2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int r = wm * 32 + 16 * i + lane % 16, c = 2 * ks + lane / 16;
        a[i] = a_base + 16 * (r * (kBK / 8) + mma::swizzle<kBK / 8>(r, c));
      }
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j)
        b[j] = mma::b_row_addr<kBK, kBN>(b_base, 0, 16 * ks,
                                         wn * kNT + 2 * j, lane);
      mma::mma_k16<kMT, kNT>(acc, a, b);
    }
  });
  // the ring is free again: stage the output tile in it

  bf16_bits* tile_s = reinterpret_cast<bf16_bits*>(smem);
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int r = wm * 32 + 16 * i + lane / 4;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = (wn * kNT + j) * 8 + 2 * (lane % 4);
      auto* dst = reinterpret_cast<std::uint32_t*>(tile_s + col);
      const float b0 = bias_s[col], b1 = bias_s[col + 1];
      dst[r * kOutStride / 2] =
          mma::pack_bf16x2(acc[i][j][0] + b0, acc[i][j][1] + b1);
      dst[(r + 8) * kOutStride / 2] =
          mma::pack_bf16x2(acc[i][j][2] + b0, acc[i][j][3] + b1);
    }
  }
  __syncthreads();
  const bool vec_o = co % 8 == 0 && cs % 8 == 0 && mma::aligned16(out);
  constexpr int NCH = kBN / 8;
  for (int e = tid; e < kBM * NCH; e += kBf16Threads) {
    const int r = e / NCH, c = e % NCH;
    const long long q0 = pix_q[r];
    const int n = n0 + 8 * c;
    if (q0 < 0 || n >= ncols) continue;
    const bf16_bits* s = tile_s + r * kOutStride + 8 * c;
    if (vec_o) {
      const int tap = n / co, ch = n - tap * co;
      const long long q = q0 + (tap >> 1) * ow + (tap & 1);
      *reinterpret_cast<uint4*>(out + q * ctot + cs + ch) =
          *reinterpret_cast<const uint4*>(s);
    } else {
      for (int u = 0; u < 8 && n + u < ncols; ++u) {
        const int tap = (n + u) / co, ch = n + u - tap * co;
        const long long q = q0 + (tap >> 1) * ow + (tap & 1);
        out[q * ctot + cs + ch] = s[u];
      }
    }
  }
}

cudaError_t launch_bf16(const void* x, const void* wv, const void* bias,
                        const void* skip, void* out, int batch, int h, int w,
                        int cin, int co, int cs, cudaStream_t stream) {
  const long long m = static_cast<long long>(batch) * h * w;
  if (m > (1LL << 31) - 1 - kBM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      upsample_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBf16Smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((4 * co + kBN - 1) / kBN));
  upsample_bf16_kernel<<<grid, kBf16Threads, kBf16Smem, stream>>>(
      static_cast<const bf16_bits*>(x), static_cast<const bf16_bits*>(wv),
      static_cast<const float*>(bias), static_cast<const bf16_bits*>(skip),
      static_cast<bf16_bits*>(out), w, static_cast<int>(m), cin, co, cs);
  return cudaGetLastError();
}

}  // namespace

extern "C" int upsample2x_concat_launch(int dtype, const void* x,
                                        const void* wv, const void* bias,
                                        const void* skip, void* out, int batch,
                                        int h, int w, int cin, int co, int cs,
                                        void* stream) {
  if (static_cast<long long>(batch) * h * w <= 0 || co <= 0)
    return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == segtpu::kFloat32) {
    launch_f32(x, wv, bias, skip, out, batch, h, w, cin, co, cs, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == segtpu::kBFloat16)
    return static_cast<int>(
        launch_bf16(x, wv, bias, skip, out, batch, h, w, cin, co, cs, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* upsample2x_concat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

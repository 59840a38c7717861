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
// What bounds it on an H100: the function's 2·M·9·Cin·Cout operations
// (M = B·H·W) over (M·Cin + 9·Cin·Cout + M·Cout) elements; at the flagship
// decoder shapes (Cin 96..512, Cout 32..256) that is 190..1400 flops per
// bf16 byte, so the least time is set by the bf16 tensor cores at levels
// 4..2 (Cout 64..256) and by the bytes at level 1 (Cout 32).
//
// bf16: an implicit GEMM on the tensor cores, f32 accumulation
// (conv_mma.cuh). A block owns a TH x TW tile of one image's output
// pixels and BN output channels. Per chunk of KC input channels it
// stages, with cp.async, the (TH+2) x (TW+2) input window (zero halo by
// zero-filled copies, so no padded copy of x exists) and the 9 taps'
// KC x BN weight rows, into a ring of STAGES XOR-swizzled buffers; one
// __syncthreads per chunk. The 9 taps read the one window through shifted
// ldmatrix row addresses, so each input pixel comes from device memory
// (or L2) once per chunk, not once per tap. The epilogue applies
// scale/bias/ReLU in f32, rounds to bf16 once, stages the tile in shared
// memory and writes it with 16-byte stores. Two kernels by width:
//   Cout > 32 (levels 4..2, operation-bound): conv_wgmma_kernel, 16x32
//     pixels x 64 channels, two warpgroups of 256 rows each issuing
//     wgmma.mma_async m64n64k16, A from registers (ldmatrix from the
//     window), B through a 128-byte-swizzled shared-memory descriptor
//     (the HWIO rows as staged, N-major); KC = 32, 3 stages, 226 KB, one
//     block per SM.
//   Cout <= 32 (level 1, bytes-bound): conv_bf16_kernel, 16x16 pixels x
//     32 channels on mma.sync m16n8k16 (8 warps of 32x32, KC = 16, 4
//     stages).
// What bounds it now: the issue rate of one block per SM in which every
// thread both copies and multiplies (no producer warp, no TMA), with one
// product group in flight per warpgroup behind the ldmatrix of its A
// rows, one __syncthreads per 32 input channels, and each block staging
// its 9·Cin·64 weights again from L2 (they are reused over only 512
// pixels).
//
// f32 (conv_f32_kernel): the CUDA-core version of the first port, kept
// because TF32 or bf16 products cannot meet the f32 tolerance (1e-4): M
// tiled as flat pixels (4x4 register tile per thread), Cin in chunks of
// kKC staged per tap, bounds tests as the zero halo.
//
// Numerics: products and sums in f32, then ·scale + bias in f32, ReLU, and
// one rounding to the output type, as the JAX kernel does.

#include "common.cuh"
#include "conv_mma.cuh"

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
conv_f32_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
  conv_f32_kernel<T, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), batch, h, wd, cin, cout);
}

void launch_f32(const void* x, const void* w, const void* scale,
                const void* bias, void* out, int batch, int h, int wd, int cin,
                int cout, cudaStream_t stream) {
  if (cout <= 32)
    launch<float, 32>(x, w, scale, bias, out, batch, h, wd, cin, cout, stream);
  else
    launch<float, 64>(x, w, scale, bias, out, batch, h, wd, cin, cout, stream);
}

// ---- bf16: tensor-core implicit GEMM (conv_mma.cuh)

namespace mma = segtpu::mma;
using mma::bf16_bits;

// One bf16 tile configuration: a TH x TW pixel tile, BN output channels,
// KC input channels per pipeline stage, WM x WN warps, STAGES buffers.
template <int TH_, int TW_, int BN_, int KC_, int WM_, int WN_, int STAGES_>
struct ConvTile {
  static constexpr int TH = TH_, TW = TW_, BN = BN_, KC = KC_, WM = WM_,
                       WN = WN_, STAGES = STAGES_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int M = TH * TW;
  static constexpr int MT = M / 16 / WM;       // m16 tiles per warp
  static constexpr int NT = BN / 8 / WN;       // n8 tiles per warp
  static constexpr int WH = TH + 2, WW = TW + 2;
  static constexpr int kWindowBytes = WH * WW * KC * 2;
  static constexpr int kStageBytes = kWindowBytes + 9 * KC * BN * 2;
  static constexpr int kOutStride = BN + 8;    // bf16 per staged output row
  static constexpr int kSmemBytes =
      STAGES * kStageBytes > M * kOutStride * 2 ? STAGES * kStageBytes
                                                : M * kOutStride * 2;
  static_assert(M % (16 * WM) == 0 && BN % (16 * WN) == 0, "warp tiling");
  static_assert(TW % 8 == 0 && KC % 16 == 0, "ldmatrix rows and k steps");
};

// The mma.sync tile, for Cout <= 32 (see the source note).
using NarrowTile = ConvTile<16, 16, 32, 16, 8, 1, 4>;

template <class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads)
conv_bf16_kernel(const bf16_bits* __restrict__ x,
                 const bf16_bits* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, bf16_bits* __restrict__ out,
                 int h, int wd, int cin, int cout, int tiles_x,
                 int tiles_per_img) {
  constexpr int TW = Cfg::TW, WW = Cfg::WW, KC = Cfg::KC, BN = Cfg::BN;
  constexpr int MT = Cfg::MT, NT = Cfg::NT, STAGES = Cfg::STAGES;
  constexpr int CH = KC / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const std::uint32_t s0 = mma::smem_addr(smem);

  const int tile = blockIdx.x % tiles_per_img;
  const long long img =
      static_cast<long long>(blockIdx.x / tiles_per_img) * h;
  const int ty0 = (tile / tiles_x) * Cfg::TH, tx0 = (tile % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / Cfg::WN, wn = warp % Cfg::WN;

  // this lane's A row for each m-tile: tile pixel m -> window pixel at
  // tap (0, 0); tap (dy, dx) adds dy·WW + dx
  int a_pix[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = (wm * MT + i) * 16 + lane % 16;
    a_pix[i] = (m / TW) * WW + m % TW;
  }
  const bool vec_x = cin % 8 == 0 && mma::aligned16(x);
  const bool vec_w = cout % 8 == 0 && mma::aligned16(w);
  const int nk = (cin + KC - 1) / KC;

  auto stage = [&](int kc) {
    const std::uint32_t base = s0 + (kc % STAGES) * Cfg::kStageBytes;
    mma::stage_window<Cfg::WH, WW, KC, Cfg::kThreads>(
        base, x, img, ty0 - 1, tx0 - 1, h, wd, cin, kc * KC, vec_x);
    mma::stage_weights<KC, BN, Cfg::kThreads>(base + Cfg::kWindowBytes, w,
                                              cin, cout, kc * KC, n0, vec_w);
  };

  float acc[MT][NT][4] = {};
  mma::pipeline<STAGES>(nk, stage, [&](int kc) {
    const std::uint32_t a_base = s0 + (kc % STAGES) * Cfg::kStageBytes;
    const std::uint32_t b_base = a_base + Cfg::kWindowBytes;
#pragma unroll 3
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * WW + tap % 3;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        std::uint32_t a[MT], b[NT / 2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int p = a_pix[i] + shift, c = 2 * ks + lane / 16;
          a[i] = a_base + 16 * (p * CH + mma::swizzle<CH>(p, c));
        }
#pragma unroll
        for (int j = 0; j < NT / 2; ++j)
          b[j] = mma::b_row_addr<KC, BN>(b_base, tap, 16 * ks,
                                         wn * NT + 2 * j, lane);
        mma::mma_k16<MT, NT>(acc, a, b);
      }
    }
  });
  // the ring is free again: stage the output tile in it

  bf16_bits* tile_s = reinterpret_cast<bf16_bits*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = (wm * MT + i) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = (wn * NT + j) * 8 + 2 * (lane % 4);
      const int n = n0 + col;
      auto* dst = reinterpret_cast<std::uint32_t*>(tile_s + col);
      dst[r * Cfg::kOutStride / 2] =
          mma::bn_relu_pack(acc[i][j][0], acc[i][j][1], scale, bias, n, cout);
      dst[(r + 8) * Cfg::kOutStride / 2] =
          mma::bn_relu_pack(acc[i][j][2], acc[i][j][3], scale, bias, n, cout);
    }
  }
  __syncthreads();
  mma::store_tile<Cfg::M, TW, BN, Cfg::kThreads>(
      out, tile_s, Cfg::kOutStride, img, ty0, tx0, h, wd, n0, cout,
      cout % 8 == 0 && mma::aligned16(out));
}

// The wgmma tile: a TH x TW pixel tile, 64 output channels (one swizzle
// atom of B), KC input channels per stage, WG warpgroups, each with
// M / WG rows as M / 64 / WG products of 64 x 64 per k16 step.
template <int TH_, int TW_, int KC_, int WG_, int STAGES_>
struct WgTile {
  static constexpr int TH = TH_, TW = TW_, KC = KC_, WG = WG_,
                       STAGES = STAGES_, BN = 64;
  static constexpr int kThreads = 128 * WG;
  static constexpr int M = TH * TW;
  static constexpr int MI = M / 64 / WG;       // m64 products per warpgroup
  static constexpr int WH = TH + 2, WW = TW + 2;
  static constexpr int kWeightBytes = 9 * KC * BN * 2;   // 1024-aligned
  static constexpr int kWindowBytes = WH * WW * KC * 2;
  static constexpr int kStageBytes =
      (kWeightBytes + kWindowBytes + 1023) / 1024 * 1024;
  static constexpr int kOutStride = BN + 8;
  // + 1024: the ring is moved up to the next 1024-byte boundary
  static constexpr int kSmemBytes =
      (STAGES * kStageBytes > M * kOutStride * 2 ? STAGES * kStageBytes
                                                 : M * kOutStride * 2) +
      1024;
  static_assert(M % (64 * WG) == 0 && KC % 16 == 0 && TW % 8 == 0,
                "warpgroup tiling, k steps and ldmatrix rows");
  static_assert(kWeightBytes % 1024 == 0, "swizzle atoms stay aligned");
};

using WgmmaTile = WgTile<16, 32, 32, 2, 3>;   // Cout > 32

// The bf16 conv on wgmma: each stage holds the 9 taps' KC x 64 weight
// rows (first, 1024-byte aligned, read through wgmma descriptors) and
// the haloed window (read per lane with ldmatrix into A registers, as in
// conv_bf16_kernel); mma::wgmma_steps runs the 9·KC/16 k16 steps.
template <class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads)
conv_wgmma_kernel(const bf16_bits* __restrict__ x,
                  const bf16_bits* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, bf16_bits* __restrict__ out,
                  int h, int wd, int cin, int cout, int tiles_x,
                  int tiles_per_img) {
  constexpr int TW = Cfg::TW, WW = Cfg::WW, KC = Cfg::KC, BN = Cfg::BN;
  constexpr int MI = Cfg::MI, STAGES = Cfg::STAGES, CH = KC / 8;
  constexpr int kSteps = 9 * KC / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const std::uint32_t raw = mma::smem_addr(smem);
  const std::uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const std::uint32_t s0 = raw + pad;

  const int tile = blockIdx.x % tiles_per_img;
  const long long img =
      static_cast<long long>(blockIdx.x / tiles_per_img) * h;
  const int ty0 = (tile / tiles_x) * Cfg::TH, tx0 = (tile % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // warpgroup g owns rows [g·M/WG, (g+1)·M/WG); its warp w the 16 rows
  // 16w.. of each of its m64 products
  const int g = warp / 4, wq = warp % 4;
  int a_pix[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int m = g * (Cfg::M / Cfg::WG) + 64 * i + 16 * wq + lane % 16;
    a_pix[i] = (m / TW) * WW + m % TW;
  }
  const bool vec_x = cin % 8 == 0 && mma::aligned16(x);
  const bool vec_w = cout % 8 == 0 && mma::aligned16(w);
  const int nk = (cin + KC - 1) / KC;

  auto stage = [&](int kc) {
    const std::uint32_t base = s0 + (kc % STAGES) * Cfg::kStageBytes;
    mma::stage_weights<KC, BN, Cfg::kThreads>(base, w, cin, cout, kc * KC,
                                              n0, vec_w);
    mma::stage_window<Cfg::WH, WW, KC, Cfg::kThreads>(
        base + Cfg::kWeightBytes, x, img, ty0 - 1, tx0 - 1, h, wd, cin,
        kc * KC, vec_x);
  };

  float acc[MI][32] = {};
  mma::pipeline<STAGES, true>(nk, stage, [&](int kc) {
    const std::uint32_t w_base = s0 + (kc % STAGES) * Cfg::kStageBytes;
    const std::uint32_t a_base = w_base + Cfg::kWeightBytes;
    // step s = (tap, 16-channel slice): A rows from the window shifted by
    // the tap, B the 16 weight rows of that tap and slice
    mma::wgmma_steps<MI, kSteps>(
        acc, w_base, [&](std::uint32_t (&af)[MI][4], int s) {
          const int tap = s / (KC / 16), ks = s % (KC / 16);
          const int shift = (tap / 3) * WW + tap % 3;
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const int p = a_pix[i] + shift, c = 2 * ks + lane / 16;
            mma::ldmatrix_x4(af[i],
                             a_base + 16 * (p * CH + mma::swizzle<CH>(p, c)));
          }
        });
  });
  // the ring is free again: stage the output tile in it

  bf16_bits* tile_s = reinterpret_cast<bf16_bits*>(smem + pad);
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = g * (Cfg::M / Cfg::WG) + 64 * i + 16 * wq + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      auto* dst = reinterpret_cast<std::uint32_t*>(tile_s + col);
      dst[r * Cfg::kOutStride / 2] = mma::bn_relu_pack(
          acc[i][4 * j], acc[i][4 * j + 1], scale, bias, n0 + col, cout);
      dst[(r + 8) * Cfg::kOutStride / 2] = mma::bn_relu_pack(
          acc[i][4 * j + 2], acc[i][4 * j + 3], scale, bias, n0 + col, cout);
    }
  }
  __syncthreads();
  mma::store_tile<Cfg::M, TW, BN, Cfg::kThreads>(
      out, tile_s, Cfg::kOutStride, img, ty0, tx0, h, wd, n0, cout,
      cout % 8 == 0 && mma::aligned16(out));
}

template <class Cfg, bool kWgmma = false>
cudaError_t launch_bf16(const void* x, const void* w, const void* scale,
                        const void* bias, void* out, int batch, int h, int wd,
                        int cin, int cout, cudaStream_t stream) {
  auto kernel = [] {
    if constexpr (kWgmma)
      return conv_wgmma_kernel<Cfg>;
    else
      return conv_bf16_kernel<Cfg>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles_x = (wd + Cfg::TW - 1) / Cfg::TW;
  const int tiles_per_img = ((h + Cfg::TH - 1) / Cfg::TH) * tiles_x;
  const dim3 grid(static_cast<unsigned>(batch * tiles_per_img),
                  static_cast<unsigned>((cout + Cfg::BN - 1) / Cfg::BN));
  kernel<<<grid, Cfg::kThreads, Cfg::kSmemBytes, stream>>>(
      static_cast<const bf16_bits*>(x), static_cast<const bf16_bits*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<bf16_bits*>(out), h, wd, cin, cout, tiles_x, tiles_per_img);
  return cudaGetLastError();
}

cudaError_t launch_bf16_for_width(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* out, int batch, int h, int wd, int cin,
                                  int cout, cudaStream_t stream) {
  if (cout <= 32)
    return launch_bf16<NarrowTile>(x, w, scale, bias, out, batch, h, wd, cin,
                                   cout, stream);
  return launch_bf16<WgmmaTile, true>(x, w, scale, bias, out, batch, h, wd,
                                      cin, cout, stream);
}

}  // namespace

extern "C" int conv3x3_bn_relu_launch(int dtype, const void* x, const void* w,
                                      const void* scale, const void* bias,
                                      void* out, int batch, int h, int wd,
                                      int cin, int cout, void* stream) {
  if (static_cast<long long>(batch) * h * wd <= 0 || cout <= 0)
    return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == segtpu::kFloat32) {
    launch_f32(x, w, scale, bias, out, batch, h, wd, cin, cout, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == segtpu::kBFloat16)
    return static_cast<int>(launch_bf16_for_width(x, w, scale, bias, out,
                                                  batch, h, wd, cin, cout, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* conv3x3_bn_relu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

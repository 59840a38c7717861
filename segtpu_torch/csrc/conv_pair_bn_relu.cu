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
// from x itself (zeros outside the image), and takes the in-image test for
// the intermediate from its own tile index.
//
// A block owns one th x tw output tile of one image, all C output
// channels.
//   1. conv 1 over the (th+2) x (tw+2) intermediate window: an implicit
//      GEMM, M1 = (th+2)(tw+2) pixels, N = C in chunks of NC, K = 9·Cin,
//      from the (th+4) x (tw+4) input window. Its epilogue applies
//      s1/b1/ReLU, writes zero at pixels outside the image (conv 2 must
//      see the 'same' padding there), rounds to T and stores into the
//      shared intermediate.
//   2. conv 2 from the shared intermediate: M2 = th·tw pixels, N = C in
//      chunks of NC, K = 9·C. Its epilogue applies s2/b2/ReLU and writes
//      each output element once.
// The intermediate never touches device memory.
//
// What bounds it on an H100: the function's work is 2·M·9·C·(Cin + C)
// operations over (M·Cin + 9·C·(Cin + C) + M·C) elements; at the flagship
// decoder shapes that is operations at the bf16 tensor-core rate for
// levels 4..2 and bytes at level 1 (256², Cin 96, C 32). On top of the
// function's work, conv 1 recomputes the halo: M1 / M2 of the output
// pixels, M1 padded to m16 rows.
//
// bf16: both products on the tensor cores with the core of conv_mma.cuh,
// f32 accumulation. conv 1 stages the input window and w1's 9 taps per
// chunk of KC = 16 input channels through a ring of cp.async buffers
// (XOR-swizzled, zero-filled halo) and reads the taps as shifted ldmatrix
// rows. The intermediate is bf16, which is already conv 2's A operand:
// conv 2 reads it through ldmatrix with a per-lane row address per tap
// and streams only w2 through the ring. Its rows are padded to Cp + 8
// channels (Cp = C rounded up to 16), an odd number of 16-byte chunks, so
// ldmatrix rows stay 16-byte aligned and fall in 8 bank groups. The tile
// is the first of these that fits the 227 KB a block may have:
//   16x16, NC = 32 for C <= 32 (the bytes-bound level 1; pair_bf16_kernel
//     on mma.sync m16n8k16, 8 warps of 48x32 in conv 1 and 32x32 in conv
//     2, two blocks per SM);
//   16x16, NC = 64 up to C = 192 (pair_wgmma_kernel, wgmma.mma_async
//     m64n64k16 with A from registers and B through a shared-memory
//     descriptor; two warpgroups split the rows: conv 1's 324 rows, 1.27x
//     the 256 outputs, in 6 products of 64);
//   8x16, NC = 128 up to C = 256 (the flagship's level 4;
//     pair_wgmma_kernel with the two warpgroups splitting the channels,
//     64 each, so both run all 3 of conv 1's products (180 rows for 128
//     outputs, 1.41x) and the input window is staged once per 128
//     channels; at B=16, 32², 128 blocks, one wave on 132 SMs);
//   8x8, NC = 32 for the widest C (up to 1008; pair_bf16_kernel, 4
//     warps, 2 stages; 100 rows for 64, 1.56x).
// What bounds it now: the issue rate, as in the conv (one block per SM
// above C = 32, no producer warp, one product group in flight per
// warpgroup), plus the halo recompute and conv 1's input window staged
// again for each chunk of NC output channels.
//
// f32 (pair_f32_kernel): the CUDA-core version of the first port, kept
// because TF32 or bf16 products cannot meet the f32 tolerance: 8x8 output
// tiles, the (8+4)² input window and both weights streamed in f32 chunks
// of kKC channels, the intermediate in f32.

#include "common.cuh"
#include "conv_mma.cuh"

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

// f32 shared bytes for NC output channels per chunk and C channels of type
// T; mirrored by segtpu_torch/kernels/fused_block.py::smem_bytes.
template <typename T, int NC>
constexpr long long smem_bytes(int c) {
  return 4LL * (kIn * kIn * kInStride + 9 * kKC * NC) +
         static_cast<long long>(kM1) * (c + 4 / sizeof(T)) * sizeof(T);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
pair_f32_kernel(const T* __restrict__ x, const T* __restrict__ w1,
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
  auto kernel = pair_f32_kernel<T, NC>;
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

cudaError_t launch_f32(const void* x, const void* w1, const void* s1,
                       const void* b1, const void* w2, const void* s2,
                       const void* b2, void* out, int batch, int h, int wd,
                       int cin, int c, cudaStream_t stream) {
  if (c <= 32)
    return launch<float, 32>(x, w1, s1, b1, w2, s2, b2, out, batch, h, wd,
                             cin, c, stream);
  return launch<float, 64>(x, w1, s1, b1, w2, s2, b2, out, batch, h, wd, cin,
                           c, stream);
}

// ---- bf16: both convs on the tensor cores (conv_mma.cuh)

namespace mma = segtpu::mma;
using mma::bf16_bits;

// Shared memory a block may have on Hopper (opt-in maximum); the bf16 tile
// is chosen against it. Mirrored by fused_block.py::SMEM_LIMIT.
constexpr long long kSmemLimit = 232448;

// One bf16 tile configuration: a TH x TW output tile, WM x WN warps, each
// with NT n8 tiles (NC = 8·WN·NT output channels per chunk), KC reduction
// channels per pipeline stage, STAGES buffers.
template <int TH_, int TW_, int WM_, int WN_, int NT_, int KC_, int STAGES_>
struct PairTile {
  static constexpr int TH = TH_, TW = TW_, WM = WM_, WN = WN_, NT = NT_,
                       KC = KC_, STAGES = STAGES_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int NC = 8 * WN * NT;
  static constexpr int MH = TH + 2, MW = TW + 2;    // intermediate window
  static constexpr int IH = TH + 4, IW = TW + 4;    // input window
  static constexpr int M1 = MH * MW, M2 = TH * TW;
  static constexpr int M1T = (M1 + 15) / 16;        // conv 1 m16 tiles
  static constexpr int MT1 = (M1T + WM - 1) / WM;   // ... per warp, at most
  static constexpr int MT2 = M2 / 16 / WM;          // conv 2 m16 tiles/warp
  static constexpr int kWindowBytes = IH * IW * KC * 2;
  static constexpr int kStageBytes = kWindowBytes + 9 * KC * NC * 2;
  static constexpr int kRingBytes = STAGES * kStageBytes;
  static constexpr int kOutStride = NC + 8;  // bf16 per staged output row
  static_assert(M2 % (16 * WM) == 0, "conv 2 warp tiling");
  static_assert(TW % 8 == 0 && KC == 16, "ldmatrix rows; one k16 per chunk");
  static_assert(M2 * kOutStride * 2 <= kRingBytes, "output staging");
  // ring + the intermediate, M1 rows of Cp + 8 bf16
  static constexpr long long smem_bytes(int c) {
    return kRingBytes + 2LL * M1 * ((c + 15) / 16 * 16 + 8);
  }
};

// The mma.sync tiles (see the source note).
using NarrowTile = PairTile<16, 16, 8, 1, 4, 16, 3>;  // NC = 32: C <= 32
using SmallTile = PairTile<8, 8, 2, 2, 2, 16, 2>;     // NC = 32, 4 warps

// One wgmma tile configuration: a TH x TW output tile, WM x WN
// warpgroups, NC = 64·WN output channels per chunk, KC reduction channels
// per stage, STAGES buffers. Warpgroup (gm, gn) computes rows gm·MI.. of
// both convs (64 x 64 wgmma products) for the 64 channels of swizzle atom
// gn. Each stage holds w's 9 taps' KC x NC rows first, as WN atoms of
// KC·9 rows of 128 bytes (1024-byte aligned, read through wgmma
// descriptors), then conv 1's input window.
template <int TH_, int TW_, int WM_, int WN_, int KC_, int STAGES_>
struct PairWgTile {
  static constexpr int TH = TH_, TW = TW_, WM = WM_, WN = WN_, KC = KC_,
                       STAGES = STAGES_, NC = 64 * WN;
  static constexpr int kThreads = 128 * WM * WN;
  static constexpr int MH = TH + 2, MW = TW + 2;    // intermediate window
  static constexpr int IH = TH + 4, IW = TW + 4;    // input window
  static constexpr int M1 = MH * MW, M2 = TH * TW;
  static constexpr int M1T = (M1 + 63) / 64;        // conv 1 m64 products
  static constexpr int MI1 = (M1T + WM - 1) / WM;   // ... per warpgroup
  static constexpr int MI2 = M2 / 64 / WM;          // conv 2, per warpgroup
  static constexpr int kAtomBytes = 9 * KC * 64 * 2;
  static constexpr int kWeightBytes = WN * kAtomBytes;
  static constexpr int kWindowBytes = IH * IW * KC * 2;
  static constexpr int kStageBytes =
      (kWeightBytes + kWindowBytes + 1023) / 1024 * 1024;
  static constexpr int kRingBytes = STAGES * kStageBytes;
  static constexpr int kOutStride = NC + 8;  // bf16 per staged output row
  static_assert(M2 % (64 * WM) == 0, "conv 2 warpgroup tiling");
  static_assert(M1T - (WM - 1) * MI1 >= MI1 - 1,
                "conv 1: the last warpgroup row is short by at most one "
                "product");
  static_assert(TW % 8 == 0 && KC % 16 == 0, "ldmatrix rows and k steps");
  static_assert(kAtomBytes % 1024 == 0, "swizzle atoms stay aligned");
  static_assert(M2 * kOutStride * 2 <= kRingBytes, "output staging");
  // 1024 (the ring is moved up to a 1024-byte boundary) + ring + the
  // intermediate, M1 rows of Cp + 8 bf16
  static constexpr long long smem_bytes(int c) {
    return 1024 + kRingBytes + 2LL * M1 * ((c + 15) / 16 * 16 + 8);
  }
};

// The wgmma tiles (see the source note).
using BigTile = PairWgTile<16, 16, 2, 1, 16, 3>;
using RectTile = PairWgTile<8, 16, 1, 2, 16, 3>;

template <class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads)
pair_bf16_kernel(const bf16_bits* __restrict__ x,
                 const bf16_bits* __restrict__ w1,
                 const float* __restrict__ s1, const float* __restrict__ b1,
                 const bf16_bits* __restrict__ w2,
                 const float* __restrict__ s2, const float* __restrict__ b2,
                 bf16_bits* __restrict__ out, int h, int wd, int cin, int c,
                 int tiles_x) {
  constexpr int TW = Cfg::TW, MW = Cfg::MW, IW = Cfg::IW, KC = Cfg::KC;
  constexpr int NC = Cfg::NC, NT = Cfg::NT, STAGES = Cfg::STAGES;
  constexpr int MT1 = Cfg::MT1, MT2 = Cfg::MT2, CH = KC / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const std::uint32_t ring = mma::smem_addr(smem);
  bf16_bits* mid = reinterpret_cast<bf16_bits*>(smem + Cfg::kRingBytes);
  const std::uint32_t mid_base = mma::smem_addr(mid);
  const int cp = (c + 15) / 16 * 16;   // intermediate channels, zero past c
  const int mid_stride = cp + 8;

  const int ty0 = (blockIdx.x / tiles_x) * Cfg::TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const long long img = static_cast<long long>(blockIdx.y) * h;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / Cfg::WN, wn = warp % Cfg::WN;
  const bool vec_x = cin % 8 == 0 && mma::aligned16(x);
  const bool vec_w = c % 8 == 0 && mma::aligned16(w1) && mma::aligned16(w2);

  // ---- conv 1: the (TH+2) x (TW+2) intermediate window, channels [0, Cp)
  // This warp's m16 tiles wm·MT1 ... (fewer for the last warp row). Its
  // lane's A row for each: intermediate pixel p -> input window pixel at
  // tap (0, 0); rows past M1 read pixel 0 and are dropped.
  const int mt1 = Cfg::M1T - wm * MT1 < MT1 ? Cfg::M1T - wm * MT1 : MT1;
  int a1_pix[MT1];
#pragma unroll
  for (int i = 0; i < MT1; ++i) {
    int p = (wm * MT1 + i) * 16 + lane % 16;
    if (p >= Cfg::M1) p = 0;
    a1_pix[i] = (p / MW) * IW + p % MW;
  }
  const int nk1 = (cin + KC - 1) / KC;
  for (int n0 = 0; n0 < cp; n0 += NC) {
    auto stage = [&](int kc) {
      const std::uint32_t base = ring + (kc % STAGES) * Cfg::kStageBytes;
      mma::stage_window<Cfg::IH, IW, KC, Cfg::kThreads>(
          base, x, img, ty0 - 2, tx0 - 2, h, wd, cin, kc * KC, vec_x);
      mma::stage_weights<KC, NC, Cfg::kThreads>(base + Cfg::kWindowBytes, w1,
                                                cin, c, kc * KC, n0, vec_w);
    };
    float acc[MT1][NT][4] = {};
    mma::pipeline<STAGES>(nk1, stage, [&](int kc) {
      const std::uint32_t a_base = ring + (kc % STAGES) * Cfg::kStageBytes;
      const std::uint32_t b_base = a_base + Cfg::kWindowBytes;
#pragma unroll 3
      for (int tap = 0; tap < 9; ++tap) {
        const int shift = (tap / 3) * IW + tap % 3;
        std::uint32_t a[MT1], b[NT / 2];
#pragma unroll
        for (int i = 0; i < MT1; ++i) {
          const int p = a1_pix[i] + shift, ch = lane / 16;
          a[i] = a_base + 16 * (p * CH + mma::swizzle<CH>(p, ch));
        }
#pragma unroll
        for (int j = 0; j < NT / 2; ++j)
          b[j] = mma::b_row_addr<KC, NC>(b_base, tap, 0, wn * NT + 2 * j,
                                         lane);
        mma::mma_k16<MT1, NT>(acc, a, b, mt1);
      }
    });
#pragma unroll
    for (int i = 0; i < MT1; ++i) {
      if (i >= mt1) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = (wm * MT1 + i) * 16 + lane / 4 + 8 * half;
        if (p >= Cfg::M1) continue;
        const int gy = ty0 - 1 + p / MW, gx = tx0 - 1 + p % MW;
        const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = n0 + (wn * NT + j) * 8 + 2 * (lane % 4);
          if (n >= cp) continue;
          *reinterpret_cast<std::uint32_t*>(mid + p * mid_stride + n) =
              inside ? mma::bn_relu_pack(acc[i][j][2 * half],
                                         acc[i][j][2 * half + 1], s1, b1, n, c)
                     : 0u;
        }
      }
    }
  }
  // (the first __syncthreads of conv 2's pipeline orders these stores
  // before any ldmatrix of the intermediate)

  // ---- conv 2: TH x TW output pixels from the intermediate
  int a2_pix[MT2];
#pragma unroll
  for (int i = 0; i < MT2; ++i) {
    const int m = (wm * MT2 + i) * 16 + lane % 16;
    a2_pix[i] = (m / TW) * MW + m % TW;
  }
  bf16_bits* tile_s = reinterpret_cast<bf16_bits*>(smem);
  const bool vec_out = c % 8 == 0 && mma::aligned16(out);
  for (int n0 = 0; n0 < c; n0 += NC) {
    auto stage = [&](int kc) {
      mma::stage_weights<KC, NC, Cfg::kThreads>(
          ring + (kc % STAGES) * Cfg::kStageBytes + Cfg::kWindowBytes, w2, c,
          c, kc * KC, n0, vec_w);
    };
    float acc[MT2][NT][4] = {};
    mma::pipeline<STAGES>(cp / KC, stage, [&](int kc) {
      const std::uint32_t b_base =
          ring + (kc % STAGES) * Cfg::kStageBytes + Cfg::kWindowBytes;
#pragma unroll 3
      for (int tap = 0; tap < 9; ++tap) {
        const int shift = (tap / 3) * MW + tap % 3;
        std::uint32_t a[MT2], b[NT / 2];
#pragma unroll
        for (int i = 0; i < MT2; ++i)
          a[i] = mid_base + 2 * ((a2_pix[i] + shift) * mid_stride + kc * KC +
                                 8 * (lane / 16));
#pragma unroll
        for (int j = 0; j < NT / 2; ++j)
          b[j] = mma::b_row_addr<KC, NC>(b_base, tap, 0, wn * NT + 2 * j,
                                         lane);
        mma::mma_k16<MT2, NT>(acc, a, b);
      }
    });
    // the ring is free again: stage the output tile in it
#pragma unroll
    for (int i = 0; i < MT2; ++i) {
      const int r = (wm * MT2 + i) * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = (wn * NT + j) * 8 + 2 * (lane % 4);
        auto* dst = reinterpret_cast<std::uint32_t*>(tile_s + col);
        dst[r * Cfg::kOutStride / 2] = mma::bn_relu_pack(
            acc[i][j][0], acc[i][j][1], s2, b2, n0 + col, c);
        dst[(r + 8) * Cfg::kOutStride / 2] = mma::bn_relu_pack(
            acc[i][j][2], acc[i][j][3], s2, b2, n0 + col, c);
      }
    }
    __syncthreads();
    mma::store_tile<Cfg::M2, TW, NC, Cfg::kThreads>(
        out, tile_s, Cfg::kOutStride, img, ty0, tx0, h, wd, n0, c, vec_out);
    __syncthreads();  // before the next chunk's copies overwrite the ring
  }
}

// The pair on wgmma: as pair_bf16_kernel, with conv 1's and conv 2's
// products split over the WM x WN warpgroups (PairWgTile) as 64 x 64
// wgmma products: A rows from the input window or the intermediate
// through ldmatrix, B through descriptors (mma::wgmma_steps). conv 1's
// rows past M1 pad the last product and are dropped.
template <class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads)
pair_wgmma_kernel(const bf16_bits* __restrict__ x,
                  const bf16_bits* __restrict__ w1,
                  const float* __restrict__ s1, const float* __restrict__ b1,
                  const bf16_bits* __restrict__ w2,
                  const float* __restrict__ s2, const float* __restrict__ b2,
                  bf16_bits* __restrict__ out, int h, int wd, int cin, int c,
                  int tiles_x) {
  constexpr int TW = Cfg::TW, MW = Cfg::MW, IW = Cfg::IW, KC = Cfg::KC;
  constexpr int NC = Cfg::NC, STAGES = Cfg::STAGES, CH = KC / 8;
  constexpr int MI1 = Cfg::MI1, MI2 = Cfg::MI2, kSteps = 9 * KC / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const std::uint32_t raw = mma::smem_addr(smem);
  const std::uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const std::uint32_t ring = raw + pad;
  bf16_bits* mid =
      reinterpret_cast<bf16_bits*>(smem + pad + Cfg::kRingBytes);
  const std::uint32_t mid_base = ring + Cfg::kRingBytes;
  const int cp = (c + 15) / 16 * 16;   // intermediate channels, zero past c
  const int mid_stride = cp + 8;

  const int ty0 = (blockIdx.x / tiles_x) * Cfg::TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const long long img = static_cast<long long>(blockIdx.y) * h;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gm = warp / 4 / Cfg::WN, gn = warp / 4 % Cfg::WN, wq = warp % 4;
  const bool vec_x = cin % 8 == 0 && mma::aligned16(x);
  const bool vec_w = c % 8 == 0 && mma::aligned16(w1) && mma::aligned16(w2);
  // rows [k0, k0 + KC) of w's 9 taps, columns [n0, n0 + NC), as WN atoms
  auto stage_w = [&](std::uint32_t base, const bf16_bits* w, int k_rows,
                     int k0, int n0) {
#pragma unroll
    for (int a = 0; a < Cfg::WN; ++a)
      mma::stage_weights<KC, 64, Cfg::kThreads>(
          base + a * Cfg::kAtomBytes, w, k_rows, c, k0, n0 + 64 * a, vec_w);
  };

  // ---- conv 1: warpgroup row gm's products gm·MI1 ... (the last row may
  // have one fewer, a second instantiation of the k loop, so that no
  // product is issued under a run-time condition); this lane's A row of
  // each: intermediate pixel p -> input window pixel
  const int mi1 = Cfg::M1T - gm * MI1 < MI1 ? Cfg::M1T - gm * MI1 : MI1;
  int a1_pix[MI1];
#pragma unroll
  for (int i = 0; i < MI1; ++i) {
    int p = (gm * MI1 + i) * 64 + 16 * wq + lane % 16;
    if (p >= Cfg::M1) p = 0;
    a1_pix[i] = (p / MW) * IW + p % MW;
  }
  const int nk1 = (cin + KC - 1) / KC;
  for (int n0 = 0; n0 < cp; n0 += NC) {
    auto stage = [&](int kc) {
      const std::uint32_t base = ring + (kc % STAGES) * Cfg::kStageBytes;
      stage_w(base, w1, cin, kc * KC, n0);
      mma::stage_window<Cfg::IH, IW, KC, Cfg::kThreads>(
          base + Cfg::kWeightBytes, x, img, ty0 - 2, tx0 - 2, h, wd, cin,
          kc * KC, vec_x);
    };
    float acc[MI1][32] = {};
    mma::pipeline<STAGES, true>(nk1, stage, [&](int kc) {
      const std::uint32_t w_base = ring + (kc % STAGES) * Cfg::kStageBytes;
      const std::uint32_t a_base = w_base + Cfg::kWeightBytes;
      const std::uint32_t b_base = w_base + gn * Cfg::kAtomBytes;
      auto load = [&](auto& af, int s) {
        constexpr int n = sizeof(af) / 16;   // products: rows of 4 words
        const int tap = s / (KC / 16), ks = s % (KC / 16);
        const int shift = (tap / 3) * IW + tap % 3;
#pragma unroll
        for (int i = 0; i < n; ++i) {
          const int p = a1_pix[i] + shift, ch = 2 * ks + lane / 16;
          mma::ldmatrix_x4(
              af[i], a_base + 16 * (p * CH + mma::swizzle<CH>(p, ch)));
        }
      };
      if constexpr (MI1 > 1) {
        if (mi1 == MI1)
          mma::wgmma_steps<MI1, kSteps>(acc, b_base, load);
        else
          mma::wgmma_steps<MI1 - 1, kSteps>(
              reinterpret_cast<float(&)[MI1 - 1][32]>(acc), b_base, load);
      } else {
        mma::wgmma_steps<MI1, kSteps>(acc, b_base, load);
      }
    });
#pragma unroll
    for (int i = 0; i < MI1; ++i) {
      if (i >= mi1) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = (gm * MI1 + i) * 64 + 16 * wq + lane / 4 + 8 * half;
        if (p >= Cfg::M1) continue;
        const int gy = ty0 - 1 + p / MW, gx = tx0 - 1 + p % MW;
        const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + 64 * gn + 8 * j + 2 * (lane % 4);
          if (n >= cp) continue;
          *reinterpret_cast<std::uint32_t*>(mid + p * mid_stride + n) =
              inside ? mma::bn_relu_pack(acc[i][4 * j + 2 * half],
                                         acc[i][4 * j + 2 * half + 1], s1,
                                         b1, n, c)
                     : 0u;
        }
      }
    }
  }
  // (the first __syncthreads of conv 2's pipeline orders these stores
  // before any ldmatrix of the intermediate)

  // ---- conv 2: TH x TW output pixels from the intermediate
  int a2_pix[MI2];
#pragma unroll
  for (int i = 0; i < MI2; ++i) {
    const int m = (gm * MI2 + i) * 64 + 16 * wq + lane % 16;
    a2_pix[i] = (m / TW) * MW + m % TW;
  }
  bf16_bits* tile_s = reinterpret_cast<bf16_bits*>(smem + pad);
  const bool vec_out = c % 8 == 0 && mma::aligned16(out);
  for (int n0 = 0; n0 < c; n0 += NC) {
    auto stage = [&](int kc) {
      stage_w(ring + (kc % STAGES) * Cfg::kStageBytes, w2, c, kc * KC, n0);
    };
    float acc[MI2][32] = {};
    mma::pipeline<STAGES, true>(cp / KC, stage, [&](int kc) {
      mma::wgmma_steps<MI2, kSteps>(
          acc, ring + (kc % STAGES) * Cfg::kStageBytes + gn * Cfg::kAtomBytes,
          [&](std::uint32_t (&af)[MI2][4], int s) {
            const int tap = s / (KC / 16), ks = s % (KC / 16);
            const int shift = (tap / 3) * MW + tap % 3;
#pragma unroll
            for (int i = 0; i < MI2; ++i)
              mma::ldmatrix_x4(
                  af[i], mid_base + 2 * ((a2_pix[i] + shift) * mid_stride +
                                         kc * KC + 16 * ks + 8 * (lane / 16)));
          });
    });
    // the ring is free again: stage the output tile in it
#pragma unroll
    for (int i = 0; i < MI2; ++i) {
      const int r = (gm * MI2 + i) * 64 + 16 * wq + lane / 4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * gn + 8 * j + 2 * (lane % 4);
        auto* dst = reinterpret_cast<std::uint32_t*>(tile_s + col);
        dst[r * Cfg::kOutStride / 2] = mma::bn_relu_pack(
            acc[i][4 * j], acc[i][4 * j + 1], s2, b2, n0 + col, c);
        dst[(r + 8) * Cfg::kOutStride / 2] = mma::bn_relu_pack(
            acc[i][4 * j + 2], acc[i][4 * j + 3], s2, b2, n0 + col, c);
      }
    }
    __syncthreads();
    mma::store_tile<Cfg::M2, TW, NC, Cfg::kThreads>(
        out, tile_s, Cfg::kOutStride, img, ty0, tx0, h, wd, n0, c, vec_out);
    __syncthreads();  // before the next chunk's copies overwrite the ring
  }
}

template <class Cfg, bool kWgmma = false>
cudaError_t launch_bf16(const void* x, const void* w1, const void* s1,
                        const void* b1, const void* w2, const void* s2,
                        const void* b2, void* out, int batch, int h, int wd,
                        int cin, int c, cudaStream_t stream) {
  const long long smem = Cfg::smem_bytes(c);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > limit) return cudaErrorInvalidValue;
  auto kernel = [] {
    if constexpr (kWgmma)
      return pair_wgmma_kernel<Cfg>;
    else
      return pair_bf16_kernel<Cfg>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles_x = (wd + Cfg::TW - 1) / Cfg::TW;
  const int tiles = ((h + Cfg::TH - 1) / Cfg::TH) * tiles_x;
  kernel<<<dim3(tiles, batch), Cfg::kThreads, static_cast<size_t>(smem),
           stream>>>(
      static_cast<const bf16_bits*>(x), static_cast<const bf16_bits*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const bf16_bits*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<bf16_bits*>(out), h, wd, cin,
      c, tiles_x);
  return cudaGetLastError();
}

cudaError_t launch_bf16_for_width(const void* x, const void* w1,
                                  const void* s1, const void* b1,
                                  const void* w2, const void* s2,
                                  const void* b2, void* out, int batch, int h,
                                  int wd, int cin, int c,
                                  cudaStream_t stream) {
  if (c <= NarrowTile::NC)
    return launch_bf16<NarrowTile>(x, w1, s1, b1, w2, s2, b2, out, batch, h,
                                   wd, cin, c, stream);
  if (BigTile::smem_bytes(c) <= kSmemLimit)
    return launch_bf16<BigTile, true>(x, w1, s1, b1, w2, s2, b2, out, batch, h,
                                      wd, cin, c, stream);
  if (RectTile::smem_bytes(c) <= kSmemLimit)
    return launch_bf16<RectTile, true>(x, w1, s1, b1, w2, s2, b2, out, batch,
                                       h, wd, cin, c, stream);
  return launch_bf16<SmallTile>(x, w1, s1, b1, w2, s2, b2, out, batch, h, wd,
                                cin, c, stream);
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
    err = launch_f32(x, w1, s1, b1, w2, s2, b2, out, batch, h, wd, cin, c, s);
  else if (dtype == segtpu::kBFloat16)
    err = launch_bf16_for_width(x, w1, s1, b1, w2, s2, b2, out, batch, h, wd,
                                cin, c, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* conv_pair_bn_relu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// that is 21..85 flops per bf16 byte, below the tensor cores' ridge of
// ~295, so the least time is set by bytes: read g and x once, write out
// once. On the CUDA cores the same flops are not below their ridge: the
// four flagship gates' 12.9 GFLOP take 0.19 ms at the f32 peak, more than
// their whole byte bound (0.15 ms), so the bf16 products must run on the
// tensor cores.
//
// bf16 (gate_bf16_kernel): a block owns 64 pixel rows; 8 warps, each 16
// rows x half of a pass over F. K = Cg + Cx streams through one 3-deep
// cp.async ring of 32-channel chunks (16-byte copies, XOR-swizzled):
// g's chunks with their rows of Ag, then x's with their rows of Ax, as
// mma.sync.m16n8k16 (bf16 in, f32 accumulate; the weights are K x F with
// F contiguous, read with ldmatrix.trans, never transposed). x's chunks
// land outside the ring and stay there, so x comes from device memory
// once and out = x·alpha is computed from shared memory. h never leaves
// the accumulators: the epilogue sums relu(h + b_h)·a_psi over a lane's
// columns, a quad shuffle and a sum over the row's two warps give psi in
// f32, alpha = sigmoid(psi + b_psi), and out leaves as 16-byte stores. A
// pass covers F <= 32, 64 or 128 columns (one tile per width, so no
// warp multiplies zero columns at the flagship widths); wider F loops
// over passes of 128 and restages g and the weights from L2, never x.
// Level 4 (16,384 pixels) gives 256 blocks of 256 threads, two per SM.
// Each block restages the weights from L2 (128 KB at the widest flagship
// gate). x's rows must fit beside the ring: Cx <= 1504 (resnet50's widest
// gate has 1024); wider bf16 gates take the CUDA-core kernel below.
//
// Reached (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W power limit; bf16,
// B = 16, CUDA events around each call after a cold-L2 flush): 0.035,
// 0.069, 0.064 and 0.203 ms at the flagship levels 4..1, 0.37 ms in sum
// against a byte bound of 0.153 ms; level 1 at 49% of its bound. The
// smaller levels' times carry the host's enqueue time past the flush: in
// a profiled forward the four launches take 0.235 ms of device time.
//
// f32 and the widest bf16 gates (attention_gate_kernel): the CUDA-core
// kernel of the first port, 128 pixel rows per block, f32 products in a
// 4x4 register tile per thread, passes of 32 columns over F. It stays for
// f32 because TF32 or bf16 products cannot meet the f32 tolerance (1e-4).
//
// Numerics: products and sums in f32, h, psi and alpha in f32 (the Pallas
// kernel rounds h and alpha to the model dtype in bf16), out rounded to
// x's type once.

#include "common.cuh"
#include "conv_mma.cuh"

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
void launch_cuda_cores(const void* g, const void* x, const void* ag,
                       const void* ax, const void* bh, const void* apsi,
                       const void* bpsi, void* out, long long m, int cg,
                       int cx, int f, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((m + kTM - 1) / kTM);
  attention_gate_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const T*>(ag), static_cast<const T*>(ax),
      static_cast<const float*>(bh), static_cast<const T*>(apsi),
      static_cast<const float*>(bpsi), static_cast<T*>(out), m, cg, cx, f);
}

// ---- bf16: both products on the tensor cores (conv_mma.cuh)

namespace mma = segtpu::mma;
using mma::bf16_bits;

// Dynamic shared memory a gate block may take: the opt-in maximum of 227
// KB less room for the static psi and alpha arrays.
constexpr long long kSmemLimit = 232448 - 2048;

// The bf16 tile: TM pixel rows, FC hidden columns per pass over F, KC
// channels of g or x per pipeline stage; WM x WN warps, each 16 rows x
// FC / WN columns.
template <int FC_>
struct GateTile {
  static constexpr int TM = 64, KC = 32, STAGES = 3, WM = 4, WN = 2;
  static constexpr int FC = FC_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int NT = FC / 8 / WN;           // n8 tiles per warp
  static constexpr int kChunkBytes = TM * KC * 2;  // TM rows x KC channels
  static constexpr int kStageBytes = kChunkBytes + KC * FC * 2;
  static constexpr int kRingBytes = STAGES * kStageBytes;
  // the ring (g chunks and weight chunks) and x's TM rows, kept whole
  static constexpr long long smem_bytes(int cx) {
    return kRingBytes + static_cast<long long>((cx + KC - 1) / KC) *
                            kChunkBytes;
  }
  static_assert(TM == 16 * WM && NT % 2 == 0, "warp tiling");
};

// out[p] = x[p] · σ(Σ_f relu(h[p, f] + bh[f]) · apsi[f] + bpsi) for the
// TM pixel rows of this block. K = Cg + Cx runs as one cp.async ring of
// KC-channel chunks, g's then x's, each with its rows of [Ag; Ax]
// (K x F, F contiguous, read with ldmatrix.trans): g's chunks pass
// through the ring, x's land in x_rows and stay there for the output. h
// stays in the accumulators; each pass over FC columns of F adds
// relu(h + bh) · apsi to the two rows a lane holds, then a quad shuffle
// and a sum over the WN warps of a row give psi, all in f32. At F > FC
// the later passes restage g (from L2) and the weights, never x.
template <class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads)
gate_bf16_kernel(const bf16_bits* __restrict__ g,
                 const bf16_bits* __restrict__ x,
                 const bf16_bits* __restrict__ ag,
                 const bf16_bits* __restrict__ ax,
                 const float* __restrict__ bh,
                 const __nv_bfloat16* __restrict__ apsi,
                 const float* __restrict__ bpsi, bf16_bits* __restrict__ out,
                 int m, int cg, int cx, int f) {
  constexpr int TM = Cfg::TM, KC = Cfg::KC, FC = Cfg::FC, NT = Cfg::NT;
  constexpr int WN = Cfg::WN, CH = KC / 8, NTHREADS = Cfg::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float psi_s[WN][TM];
  __shared__ float alpha_s[TM];
  const std::uint32_t s0 = mma::smem_addr(smem);
  const std::uint32_t x_rows = s0 + Cfg::kRingBytes;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int p0 = blockIdx.x * TM;
  const int nkg = (cg + KC - 1) / KC, nkx = (cx + KC - 1) / KC;
  const bool vec_g = cg % 8 == 0 && mma::aligned16(g);
  const bool vec_x = cx % 8 == 0 && mma::aligned16(x);
  const bool vec_w = f % 8 == 0 && mma::aligned16(ag) && mma::aligned16(ax);
  const int a_row = 16 * wm + lane % 16;  // this lane's ldmatrix row

  float psi[2] = {0.f, 0.f};  // rows 16·wm + lane / 4 and that + 8
  for (int f0 = 0; f0 < f; f0 += FC) {
    const bool first = f0 == 0;
    auto stage = [&](int kc) {
      const std::uint32_t slot = s0 + (kc % Cfg::STAGES) * Cfg::kStageBytes;
      if (kc < nkg) {
        mma::stage_rows<TM, CH, NTHREADS>(slot, g, p0, m, cg, kc * KC, cg,
                                          vec_g);
        mma::stage_rows<KC, FC / 8, NTHREADS>(slot + Cfg::kChunkBytes, ag,
                                              kc * KC, cg, f, f0, f, vec_w);
      } else {
        const int kx = kc - nkg;
        if (first)
          mma::stage_rows<TM, CH, NTHREADS>(x_rows + kx * Cfg::kChunkBytes,
                                            x, p0, m, cx, kx * KC, cx, vec_x);
        mma::stage_rows<KC, FC / 8, NTHREADS>(slot + Cfg::kChunkBytes, ax,
                                              kx * KC, cx, f, f0, f, vec_w);
      }
    };
    float acc[1][NT][4] = {};
    mma::pipeline<Cfg::STAGES>(nkg + nkx, stage, [&](int kc) {
      const std::uint32_t slot = s0 + (kc % Cfg::STAGES) * Cfg::kStageBytes;
      const std::uint32_t a_base =
          kc < nkg ? slot : x_rows + (kc - nkg) * Cfg::kChunkBytes;
      const std::uint32_t b_base = slot + Cfg::kChunkBytes;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        const int c = 2 * ks + lane / 16;
        const std::uint32_t a[1] = {
            a_base + 16 * (a_row * CH + mma::swizzle<CH>(a_row, c))};
        std::uint32_t b[NT / 2];
#pragma unroll
        for (int j = 0; j < NT / 2; ++j)
          b[j] = mma::b_row_addr<KC, FC>(b_base, 0, 16 * ks,
                                         wn * NT + 2 * j, lane);
        mma::mma_k16<1, NT>(acc, a, b);
      }
    });
    // relu(h + bh) · apsi over this lane's columns, in f32
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = f0 + (wn * NT + j) * 8 + 2 * (lane % 4) + e;
        if (col < f) {
          const float b = bh[col], ap = __bfloat162float(apsi[col]);
          psi[0] = fmaf(fmaxf(acc[0][j][e] + b, 0.f), ap, psi[0]);
          psi[1] = fmaf(fmaxf(acc[0][j][2 + e] + b, 0.f), ap, psi[1]);
        }
      }
    }
  }
  // the four lanes of a row hold its columns; then the WN warps of a row
#pragma unroll
  for (int s = 1; s < 4; s *= 2) {
    psi[0] += __shfl_xor_sync(0xffffffffu, psi[0], s);
    psi[1] += __shfl_xor_sync(0xffffffffu, psi[1], s);
  }
  if (lane % 4 == 0) {
    psi_s[wn][16 * wm + lane / 4] = psi[0];
    psi_s[wn][16 * wm + lane / 4 + 8] = psi[1];
  }
  __syncthreads();
  if (threadIdx.x < TM) {
    float s = bpsi[0];
#pragma unroll
    for (int w = 0; w < WN; ++w) s += psi_s[w][threadIdx.x];
    alpha_s[threadIdx.x] = 1.f / (1.f + expf(-s));
  }
  __syncthreads();
  // out = x · alpha from x's rows in shared memory, 16 bytes at a time
  const bool vec_o = cx % 8 == 0 && mma::aligned16(out);
  const int cx8 = (cx + 7) / 8;
  for (int e = threadIdx.x; e < TM * cx8; e += NTHREADS) {
    const int r = e / cx8, c8 = e - r * cx8;
    const int p = p0 + r;
    if (p >= m) continue;
    const int c = c8 % CH;
    const uint4 v = *reinterpret_cast<const uint4*>(
        smem + Cfg::kRingBytes + (c8 / CH) * Cfg::kChunkBytes +
        16 * (r * CH + mma::swizzle<CH>(r, c)));
    const float a = alpha_s[r];
    const std::uint32_t in[4] = {v.x, v.y, v.z, v.w};
    std::uint32_t o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      o[q] = mma::pack_bf16x2(__uint_as_float(in[q] << 16) * a,
                              __uint_as_float(in[q] & 0xffff0000u) * a);
    bf16_bits* dst = out + static_cast<long long>(p) * cx + 8 * c8;
    if (vec_o) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)  // unrolled: o stays in registers
        if (8 * c8 + u < cx)
          dst[u] = static_cast<bf16_bits>(o[u / 2] >> (16 * (u % 2)));
    }
  }
}

template <int FC>
bool launch_tensor_cores(const void* g, const void* x, const void* ag,
                         const void* ax, const void* bh, const void* apsi,
                         const void* bpsi, void* out, long long m, int cg,
                         int cx, int f, cudaStream_t stream,
                         cudaError_t* err) {
  using Cfg = GateTile<FC>;
  const long long smem = Cfg::smem_bytes(cx);
  if (f <= 0 || smem > kSmemLimit || m > (1LL << 31) - 1 - Cfg::TM)
    return false;
  *err = cudaFuncSetAttribute(gate_bf16_kernel<Cfg>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  if (*err != cudaSuccess) return true;
  const unsigned blocks = static_cast<unsigned>((m + Cfg::TM - 1) / Cfg::TM);
  gate_bf16_kernel<Cfg><<<blocks, Cfg::kThreads, smem, stream>>>(
      static_cast<const bf16_bits*>(g), static_cast<const bf16_bits*>(x),
      static_cast<const bf16_bits*>(ag), static_cast<const bf16_bits*>(ax),
      static_cast<const float*>(bh),
      static_cast<const __nv_bfloat16*>(apsi),
      static_cast<const float*>(bpsi), static_cast<bf16_bits*>(out),
      static_cast<int>(m), cg, cx, f);
  *err = cudaGetLastError();
  return true;
}

// The tensor-core tile by F (the narrowest pass that covers F, else
// passes of 128); past the shared-memory limit (x's rows of Cx > 1504
// channels, wider than any gate of the repo's models) the CUDA-core
// kernel of the first port.
cudaError_t launch_bf16(const void* g, const void* x, const void* ag,
                        const void* ax, const void* bh, const void* apsi,
                        const void* bpsi, void* out, long long m, int cg,
                        int cx, int f, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const bool done =
      f <= 32   ? launch_tensor_cores<32>(g, x, ag, ax, bh, apsi, bpsi, out,
                                          m, cg, cx, f, stream, &err)
      : f <= 64 ? launch_tensor_cores<64>(g, x, ag, ax, bh, apsi, bpsi, out,
                                          m, cg, cx, f, stream, &err)
                : launch_tensor_cores<128>(g, x, ag, ax, bh, apsi, bpsi, out,
                                           m, cg, cx, f, stream, &err);
  if (done) return err;
  launch_cuda_cores<__nv_bfloat16>(g, x, ag, ax, bh, apsi, bpsi, out, m, cg,
                                   cx, f, stream);
  return cudaGetLastError();
}

}  // namespace

extern "C" int attention_gate_launch(int dtype, const void* g, const void* x,
                                     const void* ag, const void* ax,
                                     const void* bh, const void* apsi,
                                     const void* bpsi, void* out, long long m,
                                     int cg, int cx, int f, void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == segtpu::kFloat32) {
    launch_cuda_cores<float>(g, x, ag, ax, bh, apsi, bpsi, out, m, cg, cx, f,
                             s);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == segtpu::kBFloat16)
    return static_cast<int>(
        launch_bf16(g, x, ag, ax, bh, apsi, bpsi, out, m, cg, cx, f, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* attention_gate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

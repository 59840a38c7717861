// The bf16 tensor-core core shared by conv3x3_bn_relu.cu and
// conv_pair_bn_relu.cu: cp.async staging of haloed NHWC windows and HWIO
// weight chunks into XOR-swizzled shared memory, ldmatrix fragment loads,
// and the two products on them, bf16 in and f32 accumulate:
// mma.sync.m16n8k16 per warp, and wgmma.mma_async.m64n64k16 per
// warpgroup with B read through a shared-memory descriptor.
//
// A 3x3 'same' conv is an implicit GEMM, M = output pixels, N = output
// channels, K = 9 taps x Cin. A block stages the (th+2) x (tw+2) input
// window of its th x tw pixel tile once per chunk of KC input channels:
// row = window pixel, KC/8 chunks of 16 bytes. The A fragment of tap
// (dy, dx) is then the same window read through per-lane row addresses
// shifted by dy·(tw+2) + dx, so nothing is gathered again per tap. B is
// HWIO, K x N with N contiguous: its rows are staged as they lie and read
// as the "col" operand with ldmatrix.trans, so the weights are never
// transposed.
//
// Bank conflicts: ldmatrix reads 8 rows of 16 bytes per phase, the same
// chunk of 8 consecutive rows. Chunk c of row r is stored at chunk
// swizzle<CH>(r, c) of its row, which puts those 8 reads in 8 different
// 16-byte bank groups for any row width CH (a power of two).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace segtpu {
namespace mma {

using bf16_bits = std::uint16_t;  // bf16 values moved as raw bits

__device__ __forceinline__ std::uint32_t smem_addr(const void* p) {
  return static_cast<std::uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously. With on = false the copy
// reads nothing (src-size 0) and writes 16 zero bytes; src must still be
// a valid global address, so callers pass the tensor's base pointer.
__device__ __forceinline__ void cp_async16(std::uint32_t dst, const void* src,
                                           bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(on ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared16(std::uint32_t dst,
                                            const std::uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(std::uint32_t (&r)[4],
                                            std::uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(std::uint32_t (&r)[4],
                                                  std::uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a · b on one 16x8x16 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const std::uint32_t (&a)[4],
                                          std::uint32_t b0, std::uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stored position of 16-byte chunk c in row r of a row of CH chunks.
template <int CH>
__device__ __forceinline__ int swizzle(int r, int c) {
  if constexpr (CH >= 8)
    return c ^ (r & 7);
  else
    return c ^ ((r / (8 / CH)) & (CH - 1));
}

__device__ __forceinline__ std::uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const std::uint32_t*>(&v);
}

// Eight bf16 from src[0..7] with the ones at index >= n replaced by zero:
// the plain-load staging of a chunk that cp.async cannot take (a row not
// 16-byte aligned, or a tail past Cin or Cout).
__device__ __forceinline__ void load8_tail(std::uint32_t (&v)[4],
                                           const bf16_bits* src, int n) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const std::uint32_t lo = 2 * j < n ? src[2 * j] : 0u;
    const std::uint32_t hi = 2 * j + 1 < n ? src[2 * j + 1] : 0u;
    v[j] = lo | (hi << 16);
  }
}

// Stage channels [k0, k0 + KC) of the WH x WW window of x (NHWC, C = cin)
// whose top-left pixel is (y0, x0) of the image starting at row `img`
// (= image index · h) into dst: row = window pixel, swizzled chunks.
// Pixels outside the image and channels at or past cin are zero. `vec`:
// every pixel row is 16-byte aligned (cin % 8 == 0, aligned base), so each
// chunk is one cp.async (zero-filled where out of range); otherwise each
// chunk is staged with plain loads.
template <int WH, int WW, int KC, int NTHREADS>
__device__ __forceinline__ void stage_window(std::uint32_t dst,
                                             const bf16_bits* x, long long img,
                                             int y0, int x0, int h, int wd,
                                             int cin, int k0, bool vec) {
  constexpr int CH = KC / 8;
  for (int e = threadIdx.x; e < WH * WW * CH; e += NTHREADS) {
    const int pix = e / CH, c = e % CH;
    const int gy = y0 + pix / WW, gx = x0 + pix % WW;
    const int k = k0 + 8 * c;
    const bool on = k < cin && gy >= 0 && gy < h && gx >= 0 && gx < wd;
    const std::uint32_t d = dst + 16 * (pix * CH + swizzle<CH>(pix, c));
    const bf16_bits* src = x + ((img + gy) * wd + gx) * cin + k;
    if (vec) {
      cp_async16(d, on ? src : x, on);
    } else {
      std::uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (on) load8_tail(v, src, cin - k);
      st_shared16(d, v);
    }
  }
}

// Stage rows [k0, k0 + KC) of all 9 taps of HWIO w (3, 3, cin, cout),
// columns [n0, n0 + BN), into dst as 9·KC rows (tap-major) of BN/8
// swizzled chunks; zero past cin and cout. `vec`: cout % 8 == 0 and an
// aligned base, so each chunk is one cp.async.
template <int KC, int BN, int NTHREADS>
__device__ __forceinline__ void stage_weights(std::uint32_t dst,
                                              const bf16_bits* w, int cin,
                                              int cout, int k0, int n0,
                                              bool vec) {
  constexpr int NCH = BN / 8;
  for (int e = threadIdx.x; e < 9 * KC * NCH; e += NTHREADS) {
    const int row = e / NCH, c = e % NCH;
    const int k = k0 + row % KC, n = n0 + 8 * c;
    const bool on = k < cin && n < cout;
    const std::uint32_t d = dst + 16 * (row * NCH + swizzle<NCH>(row, c));
    const bf16_bits* src =
        w + (static_cast<long long>(row / KC) * cin + k) * cout + n;
    if (vec) {
      cp_async16(d, on ? src : w, on);
    } else {
      std::uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (on) load8_tail(v, src, cout - n);
      st_shared16(d, v);
    }
  }
}

// Stage rows [r0, r0 + R) and columns [c0, c0 + 8·CH) of a row-major bf16
// matrix whose rows are `ld` elements apart into dst as R rows of CH
// swizzled 16-byte chunks (the layout stage_window and stage_weights
// give, so ldmatrix and b_row_addr read it the same way). Rows at or past
// `rows` and columns at or past `cols` are zero. `vec`: every row start
// is 16-byte aligned (ld % 8 == 0, cols % 8 == 0, aligned base), so each
// chunk is one cp.async; otherwise plain loads. The 1x1 products (the
// upsample's GEMM, the attention gate's) stage both operands with it.
template <int R, int CH, int NTHREADS>
__device__ __forceinline__ void stage_rows(std::uint32_t dst,
                                           const bf16_bits* src,
                                           long long r0, long long rows,
                                           long long ld, int c0, int cols,
                                           bool vec) {
  for (int e = threadIdx.x; e < R * CH; e += NTHREADS) {
    const int r = e / CH, c = e % CH;
    const int col = c0 + 8 * c;
    const bool on = r0 + r < rows && col < cols;
    const std::uint32_t d = dst + 16 * (r * CH + swizzle<CH>(r, c));
    const bf16_bits* s = src + (r0 + r) * ld + col;
    if (vec) {
      cp_async16(d, on ? s : src, on);
    } else {
      std::uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (on) load8_tail(v, s, cols - col);
      st_shared16(d, v);
    }
  }
}

// Shared address of this lane's ldmatrix row in a staged B chunk (rows of
// BN/8 swizzled chunks): row k0 + lane % 16 of tap `tap`, at column chunk
// `c0 + lane / 16`. One ldmatrix.x4.trans there gives the b0/b1 fragments
// of the two n8 tiles at chunks c0 and c0 + 1.
template <int KC, int BN>
__device__ __forceinline__ std::uint32_t b_row_addr(std::uint32_t base,
                                                    int tap, int k0, int c0,
                                                    int lane) {
  constexpr int NCH = BN / 8;
  const int row = tap * KC + k0 + lane % 16;
  return base + 16 * (row * NCH + swizzle<NCH>(row, c0 + lane / 16));
}

// One k16 step of a warp's MT x NT tile of m16n8 products: a[i] is this
// lane's ldmatrix row address for m-tile i (row lane % 16, k chunk
// lane / 16), b[j] its ldmatrix.trans row address for n-tiles 2j, 2j + 1.
// Only the first `mt` m-tiles are computed (a warp-uniform count). All
// fragments are loaded before the first product, so the loads of the
// next step are in flight while the tensor cores run this one's.
template <int MT, int NT>
__device__ __forceinline__ void mma_k16(float (&acc)[MT][NT][4],
                                        const std::uint32_t (&a)[MT],
                                        const std::uint32_t (&b)[NT / 2],
                                        int mt = MT) {
  static_assert(NT % 2 == 0, "n8 tiles come in pairs");
  std::uint32_t af[MT][4], bf[NT / 2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if (i < mt) ldmatrix_x4(af[i], a[i]);
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) ldmatrix_x4_trans(bf[j], b[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i < mt) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_16816(acc[i][j], af[i], bf[j / 2][2 * (j % 2)],
                  bf[j / 2][2 * (j % 2) + 1]);
    }
  }
}

// ---- wgmma (sm_90a): warpgroup products with B from shared memory

// Descriptor of a B operand tile in shared memory: 128-byte rows of 64
// bf16 (N contiguous), 16-byte chunks XOR-swizzled by row (swizzle<8>,
// which is the hardware's 128-byte pattern when the tile starts on a
// 1024-byte boundary), 8-row groups 1024 bytes apart. Both byte offsets
// are set to the group stride: with 64 columns per product the operand
// is one swizzle atom wide, so only the stride between 8-row groups is
// read.
__device__ __forceinline__ std::uint64_t wgmma_desc_b128(std::uint32_t addr) {
  constexpr std::uint64_t kGroup = 1024 >> 4;
  return static_cast<std::uint64_t>((addr & 0x3FFFF) >> 4) | (kGroup << 16) |
         (kGroup << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps a register that an in-flight wgmma reads (or writes) alive and in
// place up to this point: the compiler sees it used here.
__device__ __forceinline__ void fence_operand(std::uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
// Makes this thread's shared-memory writes (cp.async and plain stores,
// the generic proxy) visible to wgmma's reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += a · B on one 64x64x16 tile of a warpgroup: A (64 x 16) from
// registers, each warp's 16 rows in the m16n8k16 A fragment layout; B
// (16 x 64) from shared memory through `desc`, N-major (transposed);
// bf16 operands, f32 accumulators, n8 tile j in d[4j..4j+3] in the
// m16n8 C layout.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const std::uint32_t (&a)[4],
                                                std::uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// kSteps k16 steps of a warpgroup's MI products of 64 x 64: load_a(af, s)
// fills this warp's A registers of step s (16 rows of each product, with
// ldmatrix), and B of step s is the 16 rows of 64 bf16 at
// b_base + 2048·s, the layout of wgmma_desc_b128. Two sets of A
// registers: the products of step s run while step s + 1's rows load.
// Returns with every product done. MI is a compile-time count: a product
// issued under a run-time condition makes ptxas serialise the warpgroup
// around every wgmma (its C7519 "warpgroup.arrive is injected" note).
template <int MI, int kSteps, class LoadA>
__device__ __forceinline__ void wgmma_steps(float (&acc)[MI][32],
                                            std::uint32_t b_base,
                                            LoadA&& load_a) {
  std::uint32_t af[2][MI][4];
  auto keep = [&](std::uint32_t (&a)[MI][4]) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) fence_operand(a[i][q]);
  };
  load_a(af[0], 0);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const std::uint64_t desc = wgmma_desc_b128(b_base + 2048 * s);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < MI; ++i) wgmma_m64n64k16(acc[i], af[s % 2][i], desc);
    wgmma_commit();
    wgmma_wait<1>();  // step s - 1 is done with its A registers
    keep(af[(s + 1) % 2]);
    if (s + 1 < kSteps) load_a(af[(s + 1) % 2], s + 1);
  }
  wgmma_wait<0>();
  keep(af[(kSteps - 1) % 2]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int q = 0; q < 32; ++q) fence_operand(acc[i][q]);
}

// A STAGES-deep cp.async pipeline over nk chunks: stage(kc) issues the
// copies of chunk kc into buffer kc % STAGES, compute(kc) consumes them.
// One __syncthreads per chunk, which both publishes chunk kc and frees the
// buffer of chunk kc - 1 for the copies issued next. On return every copy
// has landed and every thread is past its last compute, so the caller may
// reuse the buffers. kWgmma: compute reads the buffers with wgmma, which
// needs each thread's copies fenced into the async proxy first.
template <int STAGES, bool kWgmma = false, class Stage, class Compute>
__device__ __forceinline__ void pipeline(int nk, Stage&& stage,
                                         Compute&& compute) {
  static_assert(STAGES >= 2, "a ring needs two buffers");
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) stage(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    if constexpr (kWgmma) fence_proxy_async();
    __syncthreads();
    if (kc + STAGES - 1 < nk) stage(kc + STAGES - 1);
    cp_async_commit();
    compute(kc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The epilogue of one accumulator tile: relu(acc · scale[n] + bias[n]) in
// f32 for the two columns n, n + 1 this lane holds, rounded to bf16 once
// and packed; columns at or past `cout` give 0.
__device__ __forceinline__ std::uint32_t bn_relu_pack(float a0, float a1,
                                                      const float* scale,
                                                      const float* bias,
                                                      int n, int cout) {
  const float v0 = n < cout ? fmaxf(a0 * scale[n] + bias[n], 0.f) : 0.f;
  const float v1 =
      n + 1 < cout ? fmaxf(a1 * scale[n + 1] + bias[n + 1], 0.f) : 0.f;
  return pack_bf16x2(v0, v1);
}

// Copy a staged output tile (rows of `stride` bf16 in shared memory, row
// r = tile pixel (r / TW, r % TW) at image position (ty0, tx0) + that) to
// out (NHWC, C = cout), columns [n0, n0 + BN): 16-byte stores where
// `vec` (cout % 8 == 0, aligned base), else element by element. Pixels
// outside the image and columns at or past cout are not written.
template <int M, int TW, int BN, int NTHREADS>
__device__ __forceinline__ void store_tile(bf16_bits* out,
                                           const bf16_bits* tile, int stride,
                                           long long img, int ty0, int tx0,
                                           int h, int wd, int n0, int cout,
                                           bool vec) {
  constexpr int NCH = BN / 8;
  for (int e = threadIdx.x; e < M * NCH; e += NTHREADS) {
    const int r = e / NCH, c = e % NCH;
    const int gy = ty0 + r / TW, gx = tx0 + r % TW, n = n0 + 8 * c;
    if (gy >= h || gx >= wd || n >= cout) continue;
    bf16_bits* o = out + ((img + gy) * wd + gx) * cout + n;
    const bf16_bits* s = tile + r * stride + 8 * c;
    if (vec) {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int q = 0; q < 8 && n + q < cout; ++q) o[q] = s[q];
    }
  }
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace mma
}  // namespace segtpu

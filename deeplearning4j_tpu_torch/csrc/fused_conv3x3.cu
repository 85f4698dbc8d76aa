// Fused 3x3 SAME stride-1 convolution for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_conv3x3` / `_conv3x3_kernel` in
// deeplearning4j_tpu/nn/helpers/pallas_conv.py (launcher :221, body :168):
//   u = relu?(scale*x + shift) over NHWC x [B, H, W, C]
//   y = conv3x3_SAME(u, W) + b, W [3, 3, C, N] HWIO, f32 accumulation
//   rounded to x's dtype; ssum/ssq = per-channel sums of the rounded y.
// The zero padding applies to u AFTER the prologue: a tap outside the
// image contributes exactly 0, never relu(shift).
//
// Implicit GEMM with K = 9*C: W reshaped [9C, N] is the B operand in
// HWIO order, tap-major. Two routes, picked by the wrapper
// (pallas_conv.forward_route) and checked again here:
//
// bf16 route "wgmma" (C, N multiples of 64, W <= 62, 16-byte aligned
// operands): what bounds it on an H100 SXM (3.35 TB/s, 989 TF/s bf16) is
// the tensor cores: every ResNet-50 stage is 2*M*9C*N = 7.4 GFLOP at
// batch 32 (~7.5 us) against 8-26 MB of bytes (2.4-7.7 us). The design
// (a haloed tile, prologued once, at every stage):
//   * a warpgroup owns 64 consecutive positions of the (W+2)-wide padded
//     grid: thw = 64 / (W+2) image rows (56: 1 row of 58, 28: 2 of 30,
//     14: 4 of 16, 7: the whole image, 7 of 9); the two pad columns of
//     each row are computed and dropped at the store. A block is one or
//     two warpgroups (two where the grid still gives every SM a block:
//     the two share each W stage) and a 128- (C < 512) or 64-wide tile of
//     N: 128 blocks or more at batch 32 in every stage;
//   * per 64-channel chunk the block stages each tile's haloed input,
//     (thw+2) x (W+2) positions, once, by cp.async with a zero-fill
//     predicate outside the image, as [8 channel groups][P positions][8
//     channels]: 8 consecutive positions are one 128-byte core matrix, so
//     the A operand of tap (dh, dw) is the same slab shifted by dh*(W+2)
//     + dw positions — a new descriptor start, LBO = 16*P bytes (the next
//     8 channels), SBO = 128 (the next 8 positions), and x is read from
//     device memory about (thw+2)/thw times, not 9;
//   * one in-place pass applies u = relu?(x*s + t) in bf16 pairs (the
//     plain version's bits) to the positions inside the image and leaves
//     the zero fill elsewhere, so the padding is applied to u; then the
//     nine taps run as nine wgmma groups (m64nBNk16, four k16 steps each)
//     over the same slab;
//   * W streams per (tap, chunk) as [64 x BN] stages through a ring of 4
//     filled by cp.async two steps ahead, read MN-major (imm-trans 1) as
//     it lies; the next chunk's slab lands in a second buffer meanwhile;
//     the first product overwrites the accumulators (no zero fill, which
//     made ptxas serialize the products: C7515);
//   * the epilogue (fused_conv_sm90.cuh) adds the bias in f32, rounds
//     once, stores y as 16-byte vectors and sums the rounded y per column
//     in a fixed tree into per-block partials.
// The haloed tile wastes positions at the small stages (7x7: 49 useful of
// 64 rows computed, 14x14: 196 of 256), which the fuller grid there pays
// for; no per-tap gather is used at any stage. Each block maps its slab
// positions to input pixels and its rows to y rows once, into shared
// memory: integer divisions by the runtime W+2 in every copy and every
// store had cost 10-15% of the kernel.
//
// What bounds it now (H100, PERF.md): neither the bytes nor the tensor
// cores, but each block's chain of steps — copy wait, barrier, four
// dependent k16 products on a 64-row tile — with one to four blocks per
// SM to overlap: 4-10x the operations bound per call. Tried on the card
// and dropped: a deeper W ring (6 stages) and steps of three taps (fewer
// barriers, more shared memory per block), both slower. The next step is
// a warp that only copies (mbarriers) and a persistent block per SM.
//
// f32 and every other shape or pointer: route "simple", the first design, in
// fused_conv_common.cuh: the A element for output row (b, h, w) and
// column (tap, c) is the prologued input at (h+dh-1, w+dw-1, c), read
// straight from x (up to 9 times, through L1/L2) into register-prefetched
// 64x64 tiles, mma.sync for bf16, FMA for f32 (no TF32).
#include "fused_conv_sm90.cuh"

namespace {

template <typename T>
struct Conv3x3Loader {
  static constexpr int VEC = dl4j::VecOf<T>::N;
  const T* x;
  const float* scale;   // nullptr = no affine
  const float* shift;
  int B, H, W, C;
  bool relu;
  bool vec;             // C, N multiples of VEC and 16-byte aligned tensors

  struct Col {
    int kk;             // first of VEC consecutive columns (tap-major)
    // vec: the VEC columns share one tap (C % VEC == 0)
    long long off;      // x offset of the tap's first element from the row's
    int dh, dw;         // tap offsets in -1..1
    float s[VEC], t[VEC];   // scale/shift rounded to T
  };

  __device__ __forceinline__ dl4j::RowInfo row_info(int row) const {
    if (row >= B * H * W) return dl4j::RowInfo{0, -1, 0};
    const int wq = row % W, t = row / W;
    return dl4j::RowInfo{(long long)row * C, t % H, wq};
  }

  __device__ __forceinline__ Col column(int kk) const {
    Col col;
    col.kk = kk;
    const int tap = kk / C, c = kk - tap * C;
    col.dh = tap / 3 - 1;
    col.dw = tap % 3 - 1;
    col.off = ((long long)col.dh * W + col.dw) * C + c;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const int cq = (kk + q) % C;   // the channel of column kk + q
      const bool on = scale != nullptr && kk + q < 9 * C;
      col.s[q] = on ? dl4j::rnd<T>(scale[cq]) : 0.0f;
      col.t[q] = on ? dl4j::rnd<T>(shift[cq]) : 0.0f;
    }
    return col;
  }

  // SAME zero padding applies to u after the prologue: a tap outside the
  // image (or a row past M, or a column past 9C) contributes exactly 0
  __device__ __forceinline__ float one(const dl4j::RowInfo& r, int kk,
                                       float s, float t) const {
    if (r.h < 0 || kk >= 9 * C) return 0.0f;
    const int tap = kk / C, c = kk - tap * C;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    const int hh = r.h + dh, ww = r.w + dw;
    if (hh < 0 || hh >= H || ww < 0 || ww >= W) return 0.0f;
    const float xv = dl4j::Num<T>::to_f(
        x[r.base + ((long long)dh * W + dw) * C + c]);
    return dl4j::prologue<T>(xv, scale != nullptr, s, t, false, 0.0f, relu);
  }

  __device__ __forceinline__ void load(int, const dl4j::RowInfo& r,
                                       const Col& c, float* out) const {
    if (!vec) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) out[q] = one(r, c.kk + q, c.s[q], c.t[q]);
      return;
    }
    const int hh = r.h + c.dh, ww = r.w + c.dw;
    if (r.h < 0 || c.kk >= 9 * C || hh < 0 || hh >= H || ww < 0 || ww >= W) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) out[q] = 0.0f;
      return;
    }
    float xv[VEC];
    dl4j::unpack<T>(*reinterpret_cast<const uint4*>(x + r.base + c.off), xv);
#pragma unroll
    for (int q = 0; q < VEC; ++q)
      out[q] = dl4j::prologue<T>(xv[q], scale != nullptr, c.s[q], c.t[q],
                                 false, 0.0f, relu);
  }

  __device__ __forceinline__ void emit(int, const Col&, const float*) const {}
};

template <typename T>
cudaError_t run(const void* x, const void* w, const void* b,
                const void* scale, const void* shift, void* y, void* partial,
                void* ssum, void* ssq, int B, int H, int W, int C, int N,
                int relu, cudaStream_t stream) {
  constexpr int VEC = dl4j::VecOf<T>::N;
  const bool vec = C % VEC == 0 && N % VEC == 0 && dl4j::aligned16(x) &&
                   dl4j::aligned16(w);
  Conv3x3Loader<T> ld{static_cast<const T*>(x),
                      static_cast<const float*>(scale),
                      static_cast<const float*>(shift), B, H, W, C,
                      relu != 0, vec != 0};
  return dl4j::launch_fused_gemm<T>(
      ld, static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), static_cast<float*>(partial),
      static_cast<float*>(ssum), static_cast<float*>(ssq), B * H * W, 9 * C,
      N, stream);
}


// ------------------------------------------------ the bf16 (wgmma) route

namespace wg {

using bf16 = __nv_bfloat16;
namespace fwd = dl4j::fwd;
namespace sm90 = dl4j::sm90;
using fwd::CH;

// how the wgmma route tiles one call: a warpgroup tile is thw image rows
// of one image (64 positions of the padded grid), tpi tiles per image, T
// in all; P slab positions per channel group (odd: the 16-byte copies of
// one position's 8 channel groups fall in distinct banks)
struct Geo {
  int thw, tpi, T, P, wgs, bn;
};

inline Geo geo(int B, int H, int W, int C, int N) {
  Geo g;
  g.thw = fwd::WG_ROWS / (W + 2);
  g.tpi = (H + g.thw - 1) / g.thw;
  g.T = B * g.tpi;
  g.P = 67 + 2 * (W + 2);   // q + dh*(W+2) + dw < 64 + 2*(W+2) + 2
  g.bn = N % 128 == 0 && C < 512 ? 128 : 64;   // from (C, N) alone
  g.wgs = fwd::warpgroups(g.T, N, g.bn, 1);
  return g;
}

struct Args {
  const bf16* x;
  const bf16* w;
  const float* bias;    // nullptr = no bias
  const float* scale;   // nullptr = no affine
  const float* shift;
  bf16* y;
  float* partial;       // nullptr = no statistics
  int B, H, W, C, N;
  int thw, tpi, T, P;
  bool relu;
};

// dynamic shared memory: slab buffers (one per chunk in flight, at most
// two), the W ring (the epilogue's staging once the product is done), the
// affine pairs [C/2] x 2, the bias tile, and the block's maps from slab
// position to input pixel and from block row to y row
template <int WGS, int BN>
struct Layout {
  int slab, sbuf, region, bytes;   // slab: elements of one buffer
  __host__ __device__ Layout(int C, int P) {
    slab = WGS * 8 * P * 8;
    sbuf = C / CH < 2 ? C / CH : 2;
    const int ops = sbuf * slab * 2 + fwd::STAGES * CH * BN * 2;
    region = ops > fwd::Epi<WGS, BN>::BYTES ? ops : fwd::Epi<WGS, BN>::BYTES;
    bytes = region + C * 4 + BN * 4 + WGS * (P + fwd::WG_ROWS) * 4;
  }
};

template <int WGS, int BN>
__global__ void __launch_bounds__(WGS * 128) conv3x3_wgmma_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<WGS, BN> L(a.C, a.P);
  bf16* slabs = reinterpret_cast<bf16*>(smem);
  bf16* wring = slabs + L.sbuf * L.slab;
  const fwd::AffinePairs ap{
      reinterpret_cast<__nv_bfloat162*>(smem + L.region),
      reinterpret_cast<__nv_bfloat162*>(smem + L.region + a.C * 2)};
  float* bias_s = reinterpret_cast<float*>(smem + L.region + a.C * 4);
  int* pix = reinterpret_cast<int*>(bias_s + BN);   // [WGS * P]
  int* yrow = pix + WGS * a.P;                      // [WGS * 64]
  const int tid = threadIdx.x, wgi = tid / 128;
  const int n0 = blockIdx.y * BN, Wp = a.W + 2, P = a.P;
  const int nch = a.C / CH, steps = 9 * nch;
  const bool aff = a.scale != nullptr, transform = aff || a.relu;
  ap.fill(a.scale, a.shift, a.C);
  fwd::fill_bias<BN>(bias_s, a.bias, n0);

  // warpgroup tile w of this block: its image (-1: past the last tile)
  // and first output row
  auto tile = [&](int w, int& img, int& h0) {
    const int ti = blockIdx.x * WGS + w;
    img = ti < a.T ? ti / a.tpi : -1;
    h0 = ti < a.T ? (ti % a.tpi) * a.thw : 0;
  };
  // the input pixel at slab position p of tile (img, h0), -1 where the
  // position is padding (outside the image, or slack around the slab)
  auto pixel = [&](int img, int h0, int p) {
    if (img < 0 || p < 1) return -1;
    const int pr = (p - 1) / Wp, pc = (p - 1) % Wp;
    const int hh = h0 - 1 + pr, ww = pc - 1;
    if (pr >= a.thw + 2 || hh < 0 || hh >= a.H || ww < 0 || ww >= a.W)
      return -1;
    return (img * a.H + hh) * a.W + ww;
  };
  // the maps, once per block (integer divisions by runtime values are
  // dear): pix[w * P + p] = pixel of tile w's slab position p, yrow[r] =
  // the y row of block row r: warpgroup tile r / 64, padded-grid
  // position q = r % 64 (-1: none)
  for (int i = tid; i < WGS * P; i += blockDim.x) {
    int img, h0;
    tile(i / P, img, h0);
    pix[i] = pixel(img, h0, i % P);
  }
  for (int r = tid; r < WGS * fwd::WG_ROWS; r += blockDim.x) {
    const int q = r % fwd::WG_ROWS;
    int img, h0;
    tile(r / fwd::WG_ROWS, img, h0);
    const int hq = h0 + q / Wp, wq = q % Wp - 1;
    yrow[r] = img < 0 || q >= a.thw * Wp || hq >= a.H || wq < 0 || wq >= a.W
                  ? -1
                  : (img * a.H + hq) * a.W + wq;
  }
  __syncthreads();
  // unit o of a slab buffer: position i = o / 8 of the block's WGS * P
  // (tile i / P, WGS <= 2), channel group o % 8 (8 threads copy one
  // position's 128 bytes); stored at [tile][channel group][position]
  auto unit = [&](int o, int& i, int& cg) {
    i = o >> 3;
    cg = o & 7;
    const int w = WGS == 2 && i >= P ? 1 : 0;
    return (w * 8 * P + cg * P + i - w * P) * 8;
  };
  auto load = [&](int j) {
    if (j < steps) {
      const int c = j / 9, tap = j % 9;
      if (tap == 0) {   // the chunk's slab, with the tap-0 weights
        bf16* sl = slabs + (c % L.sbuf) * L.slab;
        for (int o = tid; o < WGS * 8 * P; o += blockDim.x) {
          int i, cg;
          const int e = unit(o, i, cg);
          const int px = pix[i];
          sm90::cp_async16(sl + e,
                           px >= 0 ? a.x + (size_t)px * a.C + c * CH + cg * 8
                                   : a.x,
                           px >= 0);
        }
      }
      fwd::load_w<BN>(wring + (j % fwd::STAGES) * CH * BN, a.w, a.N,
                      tap * a.C + c * CH, n0);
    }
    sm90::cp_async_commit();   // possibly empty: keeps the group count
  };
  // in place: x -> u inside the image; the padding keeps its zero fill
  auto prologue = [&](int c) {
    bf16* sl = slabs + (c % L.sbuf) * L.slab;
    for (int o = tid; o < WGS * 8 * P; o += blockDim.x) {
      int i, cg;
      const int e = unit(o, i, cg);
      if (pix[i] < 0) continue;
      uint4* v = reinterpret_cast<uint4*>(sl + e);
      *v = ap.apply(*v, make_uint4(0u, 0u, 0u, 0u), (c * CH + cg * 8) / 2,
                    aff, false, a.relu);
    }
  };

  float acc[BN / 2];   // defined by the first product (mma_chunk)
  for (int j = 0; j < fwd::LEAD; ++j) load(j);
  for (int j = 0; j < steps; ++j) {
    const int c = j / 9, tap = j % 9;
    sm90::cp_async_wait<fwd::LEAD - 1>();   // step j's copies landed
    sm90::fence_proxy_async();
    __syncthreads();   // ... for every thread; wgmma(j - 2) is done
    load(j + fwd::LEAD);   // W into the stage of step j - 2; a slab into
                           // the buffer of chunk c - 1 or earlier, done
    if (tap == 0 && transform) {
      prologue(c);
      sm90::fence_proxy_async();   // u visible to wgmma
      __syncthreads();
    }
    const bf16* A = slabs + (c % L.sbuf) * L.slab + wgi * 8 * P * 8 +
                    ((tap / 3) * Wp + tap % 3) * 8;
    fwd::mma_chunk<BN>(acc, A, P * 16, 128,
                       wring + (j % fwd::STAGES) * CH * BN, j == 0);
    sm90::wgmma_wait<1>();   // step j - 1's product is done
  }
  sm90::wgmma_wait<0>();
  sm90::fence_acc<BN>(acc);
  sm90::cp_async_wait<0>();
  __syncthreads();   // the operand buffers are free for the epilogue
  const auto row_of = [yrow](int r) { return yrow[r]; };
  fwd::epilogue<WGS, BN>(acc, row_of, bias_s, a.y, a.N, n0, a.partial,
                         gridDim.x, blockIdx.x, smem);
}

inline int row_tiles(const Geo& g) { return (g.T + g.wgs - 1) / g.wgs; }

template <int WGS, int BN>
cudaError_t launch(const Args& a, const Geo& g, cudaStream_t stream) {
  const Layout<WGS, BN> L(a.C, a.P);
  if (L.bytes > fwd::SMEM_MAX) return cudaErrorInvalidValue;
  const dim3 grid(row_tiles(g), a.N / BN);
  conv3x3_wgmma_kernel<WGS, BN><<<grid, WGS * 128, L.bytes, stream>>>(a);
  return cudaGetLastError();
}

// the shapes and pointers this route takes
bool fits(const void* x, const void* w, const void* y, int B, int H, int W,
          int C, int N) {
  return dl4j::aligned16(x) && dl4j::aligned16(w) && dl4j::aligned16(y) &&
         B > 0 && H > 0 && W > 0 && W + 2 <= fwd::WG_ROWS && C % CH == 0 &&
         N % 64 == 0;
}

cudaError_t run(Args a, cudaStream_t stream) {
  if (!fits(a.x, a.w, a.y, a.B, a.H, a.W, a.C, a.N))
    return cudaErrorInvalidValue;
  const Geo g = geo(a.B, a.H, a.W, a.C, a.N);
  a.thw = g.thw;
  a.tpi = g.tpi;
  a.T = g.T;
  a.P = g.P;
  if (g.wgs == 2)
    return g.bn == 128 ? launch<2, 128>(a, g, stream)
                       : launch<2, 64>(a, g, stream);
  return g.bn == 128 ? launch<1, 128>(a, g, stream)
                     : launch<1, 64>(a, g, stream);
}

}  // namespace wg

}  // namespace

extern "C" {
// rows of the [2, tiles, N] statistics partials on `route` (0 simple,
// 1 wgmma): the wrapper sizes the scratch with it
int dl4j_conv3x3_row_tiles(int route, int B, int H, int W, int C, int N) {
  if (route) return wg::row_tiles(wg::geo(B, H, W, C, N));
  return (B * H * W + dl4j::BM - 1) / dl4j::BM;
}

// once, when the library is loaded: the wgmma route's blocks may use
// more than 48 KB of dynamic shared memory
int dl4j_init() {
  namespace fwd = dl4j::fwd;
  cudaError_t e = fwd::allow_smem(wg::conv3x3_wgmma_kernel<1, 64>);
  if (e == cudaSuccess) e = fwd::allow_smem(wg::conv3x3_wgmma_kernel<1, 128>);
  if (e == cudaSuccess) e = fwd::allow_smem(wg::conv3x3_wgmma_kernel<2, 64>);
  if (e == cudaSuccess) e = fwd::allow_smem(wg::conv3x3_wgmma_kernel<2, 128>);
  return static_cast<int>(e);
}

int fused_conv3x3_launch(int is_bf16, const void* x, const void* w,
                         const void* b, const void* scale, const void* shift,
                         void* y, void* partial, void* ssum, void* ssq, int B,
                         int H, int W, int C, int N, int relu, int route,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (route != 0) {
    if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    using bf16 = __nv_bfloat16;
    const wg::Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                     static_cast<const float*>(b),
                     static_cast<const float*>(scale),
                     static_cast<const float*>(shift), static_cast<bf16*>(y),
                     static_cast<float*>(partial), B, H, W, C, N,
                     0, 0, 0, 0, relu != 0};
    e = wg::run(a, st);
    if (e == cudaSuccess && partial != nullptr)
      e = dl4j::reduce_stats(
          static_cast<const float*>(partial),
          dl4j_conv3x3_row_tiles(1, B, H, W, C, N), N,
          static_cast<float*>(ssum), static_cast<float*>(ssq), st);
  } else {
    e = is_bf16 ? run<__nv_bfloat16>(x, w, b, scale, shift, y, partial, ssum,
                                     ssq, B, H, W, C, N, relu, st)
                : run<float>(x, w, b, scale, shift, y, partial, ssum, ssq, B,
                             H, W, C, N, relu, st);
  }
  return static_cast<int>(e);
}
}

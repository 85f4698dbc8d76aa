// Fused weight gradient of the 1x1 convolution for Hopper (sm_90a).
//
// Replaces the TPU kernel `wgrad_conv1x1` / `_wgrad1x1_kernel` in
// deeplearning4j_tpu/nn/helpers/pallas_conv.py (launcher :469, body :437):
//   u    = relu?(x*s1 + t1 [+ x2 (*s2 + t2)])   recomputed, compute dtype
//   ybar = dy + dssum + 2*y*dssq                 f32, rounded to u's dtype
//   dW   = u^T @ ybar                            [K, N], f32 accumulation
// dy, y [M, N]; x, x2 [M, K]; s*, t* [K] f32; dssum, dssq [N] f32; f32 or
// bf16 inputs, dW f32.
//
// dW contracts over M, so the output has few tiles while M is large
// (401,408 rows at ResNet-50's first stage, batch 128). The TPU kernel
// accumulates dW across its sequential grid; here M is split into
// `splits` ranges of whole 32-row chunks, one block per (tile of dW,
// range) computes that range's partial in f32 into a [splits, K, N]
// scratch, and a second kernel sums the ranges in a fixed order (no
// atomics: the same bits on every run). The wrapper sizes `splits`
// (pallas_conv.wgrad_splits) from the route's tile.
//
// Two routes, picked by the wrapper (pallas_conv.backward_route) from
// dtype, shape and alignment and checked again here:
//
// bf16 route (K, N multiples of 64, 16-byte aligned operands): what bounds
// it on an H100 SXM (3.35 TB/s, 989 TF/s bf16) is memory: it must read
// dy, y, x (x2) once and write dW once in f32, for 2*M*K*N operations,
// under the card's ridge at ResNet-50's widths. The design:
//   * dW tiles of 128x128 (64 where K or N is not a multiple of 128), two
//     warpgroups of 256 threads, so x is re-read N/128 times and dy/y
//     K/128 times (mostly from L2), not N/64 and K/64;
//   * the split's rows in 32-row chunks through a ring of 3 shared-memory
//     stages filled by cp.async (zero fill past the range): chunk i+1 is
//     in flight while chunk i is transformed and multiplied, and two
//     blocks share an SM (~100 KB each), so the transform of one overlaps
//     the other's copies and products. cp.async and not TMA: every tile
//     passes through a transform by threads anyway, and the ragged edge
//     is a per-copy predicate;
//   * x (x2) and dy (y) land in their natural row-major order, as the
//     MN-major core matrices wgmma reads; a transform pass turns them into
//     u and ybar in place, 16 bytes per thread, at the plain version's
//     rounding points (u in bf16 pairs, TileAffine::u2, the same bits as
//     TileAffine::u; ybar in f32, ybar_f32), with no transposed
//     element-wise stores; then fence.proxy.async and wgmma m64nNk16 reads
//     both operands from shared memory (imm-trans 1: MN-major), the
//     product of chunk i overlapping the transform of chunk i+1;
//   * the accumulators go to dW (or the split's partial) straight from
//     registers as 8-byte stores.
// On the H100 (700 W) this route runs at 2.2-13x its bound per call and
// 3.7x summed over a ResNet-50 train step (PERF.md): the large-M calls
// near the memory bound; where K or N is large the transform is, since
// ybar is formed again for each of the K/128 tiles of dW (u for each of
// the N/128), in f32 where u takes bf16 pairs.
//
// f32 and every other shape or pointer: the simple design of PR 2 (64x64
// tiles, 128 threads, transposed loads into shared memory, mma.sync for
// bf16, FMA for f32; the f32 path must not use TF32), in
// conv1x1_backward.cuh.
#include "conv1x1_backward.cuh"
#include "wgmma_sm90.cuh"

namespace {

using dl4j::BK;
using dl4j::BM;
using dl4j::BN;
using dl4j::THREADS;

template <typename T>
struct WgradArgs {
  const T* dy;
  const T* y;
  const T* x;
  const T* x2;          // nullptr = one branch
  const float* s1;      // nullptr = plain branch
  const float* t1;
  const float* s2;
  const float* t2;
  const float* dssum;   // nullptr = no statistics cotangent
  const float* dssq;
  float* out;           // dW, or the [splits, K, N] scratch
  int M, K, N;
  int rows;             // rows per split, a multiple of BK
  bool relu, vec_x, vec_y;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) wgrad_kernel(WgradArgs<T> a) {
  __shared__ float Cs[BM][BN + 4];
  __shared__ dl4j::TileAffine aff;
  const int k0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int r0 = blockIdx.z * a.rows, r1 = min(a.M, r0 + a.rows);
  aff.fill<T>(a.s1, a.t1, a.s2, a.t2, k0, a.K);
  __syncthreads();   // the u operand reads the affines as it loads
  const dl4j::UtOp<T> A{a.x, a.x2, &aff, a.M, a.K, k0, a.s1 != nullptr,
                        a.s2 != nullptr, a.relu, a.vec_x};
  const dl4j::YbarOp<T, false> B{a.dy, a.y, a.dssum, a.dssq, a.M, a.N,
                                 a.vec_y};
  dl4j::gemm_nt<T>(A, B, k0, n0, r0, r1, Cs);
  __syncthreads();
  float* out = a.out + (size_t)blockIdx.z * a.K * a.N;
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int k = k0 + r, n = n0 + c;
    if (k < a.K && n < a.N) out[(size_t)k * a.N + n] = Cs[r][c];
  }
}

// dw[i] = sum over s in order of p[s * len + i]
__global__ void split_sum_kernel(const float* __restrict__ p, int splits,
                                 size_t len, float* __restrict__ dw) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += p[(size_t)z * len + i];
  dw[i] = s;
}

// ------------------------------------------------ the bf16 (wgmma) route

namespace wg {

using bf16 = __nv_bfloat16;
namespace sm90 = dl4j::sm90;
constexpr int CH = 32;        // reduction (M) chunk: the split's row unit
constexpr int STAGES = 3;     // ring: chunk i+1 in flight during i
constexpr int THREADS = 256;  // two warpgroups
constexpr int BLOCKS_PER_SM = 2;   // ~100 KB of shared memory each

// dW tile TK x TN; each of the two warpgroups takes 64 of TK's rows (TK
// = 128) or half of TN's columns (TK = 64)
template <int TK, int TN>
struct Tile {
  static constexpr int NW = TK == 128 ? TN : TN / 2;   // wgmma width
  static constexpr int X = CH * TK * 2;   // bytes of an x (x2) stage
  static constexpr int Y = CH * TN * 2;   // bytes of a dy (y) stage
  static constexpr int STAGE = 2 * X + 2 * Y;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int AFF = sizeof(dl4j::TileAffineW<TK>);
  static constexpr int BYTES = RING + AFF + 2 * TN * 4;
  static_assert(BYTES * BLOCKS_PER_SM <= 233472 - 1024 * BLOCKS_PER_SM,
                "the blocks of an SM need more shared memory than it has");
};

// The chunk's tiles arrive in their natural row-major [rows x C] order,
// 16 bytes (8 channels of one row) at a time, and are stored as the
// MN-major core matrices wgmma reads: 16-byte unit o holds row o % 8 of
// 8-row group o / (8 * W / 8) and channel group (o / 8) % (W / 8), so
// SBO (along the channels) = 128 bytes, LBO (along the rows) = 16 * W.
template <int W>
__device__ __forceinline__ void unit(int o, int& row, int& ch) {
  row = (o / (8 * (W / 8))) * 8 + o % 8;
  ch = ((o / 8) % (W / 8)) * 8;
}

template <int TK, int TN>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
wgrad_wgmma_kernel(WgradArgs<bf16> a) {
  using S = Tile<TK, TN>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto* aff = reinterpret_cast<dl4j::TileAffineW<TK>*>(smem + S::RING);
  float* dsum = reinterpret_cast<float*>(smem + S::RING + S::AFF);
  float* dsq = dsum + TN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, wgi = warp / 4;
  const int k0 = blockIdx.x * TK, n0 = blockIdx.y * TN;
  const int r0 = blockIdx.z * a.rows, r1 = min(a.M, r0 + a.rows);
  const int nch = (r1 - r0 + CH - 1) / CH;
  const bool has_x2 = a.x2 != nullptr, stats = a.dssum != nullptr;
  const bool aff1 = a.s1 != nullptr, aff2 = a.s2 != nullptr;

  aff->template fill<bf16>(a.s1, a.t1, a.s2, a.t2, k0, a.K);
  for (int j = tid; j < TN; j += THREADS) {
    dsum[j] = stats ? a.dssum[n0 + j] : 0.0f;
    dsq[j] = stats ? a.dssq[n0 + j] : 0.0f;
  }

  auto stage = [&](int c) { return smem + (c % STAGES) * S::STAGE; };
  auto load_chunk = [&](int c) {
    if (c < nch) {
      unsigned char* st = stage(c);
      bf16* xs = reinterpret_cast<bf16*>(st);
      bf16* x2s = reinterpret_cast<bf16*>(st + S::X);
      bf16* dys = reinterpret_cast<bf16*>(st + 2 * S::X);
      bf16* ys = reinterpret_cast<bf16*>(st + 2 * S::X + S::Y);
      const int m0 = r0 + c * CH;
      for (int o = tid; o < CH * TK / 8; o += THREADS) {
        int r, ch;
        unit<TK>(o, r, ch);
        const bool ok = m0 + r < r1;
        const size_t e = (size_t)(ok ? m0 + r : 0) * a.K + k0 + ch;
        sm90::cp_async16(xs + o * 8, a.x + e, ok);
        if (has_x2) sm90::cp_async16(x2s + o * 8, a.x2 + e, ok);
      }
      for (int o = tid; o < CH * TN / 8; o += THREADS) {
        int r, ch;
        unit<TN>(o, r, ch);
        const bool ok = m0 + r < r1;
        const size_t e = (size_t)(ok ? m0 + r : 0) * a.N + n0 + ch;
        sm90::cp_async16(dys + o * 8, a.dy + e, ok);
        if (stats) sm90::cp_async16(ys + o * 8, a.y + e, ok);
      }
    }
    sm90::cp_async_commit();   // possibly empty: keeps the group count
  };
  // in place: x -> u (the forward prologue's rounding), dy -> ybar (f32,
  // rounded once); rows past the split's range become 0
  auto transform = [&](int c) {
    unsigned char* st = stage(c);
    bf16* xs = reinterpret_cast<bf16*>(st);
    const bf16* x2s = reinterpret_cast<const bf16*>(st + S::X);
    bf16* dys = reinterpret_cast<bf16*>(st + 2 * S::X);
    const bf16* ys = reinterpret_cast<const bf16*>(st + 2 * S::X + S::Y);
    const int m0 = r0 + c * CH;
    for (int o = tid; o < CH * TK / 8; o += THREADS) {
      int r, ch;
      unit<TK>(o, r, ch);
      uint4 xv = *reinterpret_cast<const uint4*>(xs + o * 8);
      const uint4 x2v = has_x2 ? *reinterpret_cast<const uint4*>(x2s + o * 8)
                               : make_uint4(0u, 0u, 0u, 0u);
      __nv_bfloat162* u = reinterpret_cast<__nv_bfloat162*>(&xv);
      const __nv_bfloat162* x2p =
          reinterpret_cast<const __nv_bfloat162*>(&x2v);
      const bool ok = m0 + r < r1;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        u[q] = ok ? aff->u2(u[q], aff1, has_x2, x2p[q], aff2, a.relu,
                            ch / 2 + q)
                  : __float2bfloat162_rn(0.0f);
      *reinterpret_cast<uint4*>(xs + o * 8) = xv;
    }
    for (int o = tid; o < CH * TN / 8; o += THREADS) {
      int r, ch;
      unit<TN>(o, r, ch);
      float dv[8], yv[8] = {0, 0, 0, 0, 0, 0, 0, 0}, yb[8];
      float4 sm[2], sq[2];   // dssum, dssq of the unit's 8 columns
      dl4j::unpack<bf16>(*reinterpret_cast<const uint4*>(dys + o * 8), dv);
      if (stats) {
        dl4j::unpack<bf16>(*reinterpret_cast<const uint4*>(ys + o * 8), yv);
        sm[0] = *reinterpret_cast<const float4*>(dsum + ch);
        sm[1] = *reinterpret_cast<const float4*>(dsum + ch + 4);
        sq[0] = *reinterpret_cast<const float4*>(dsq + ch);
        sq[1] = *reinterpret_cast<const float4*>(dsq + ch + 4);
      }
      const float* smf = stats ? reinterpret_cast<const float*>(sm) : nullptr;
      const float* sqf = reinterpret_cast<const float*>(sq);
      const bool ok = m0 + r < r1;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        yb[q] = ok ? dl4j::ybar_f32(dv[q], yv[q], smf, sqf, q) : 0.0f;
      *reinterpret_cast<uint4*>(dys + o * 8) = dl4j::pack<bf16>(yb);
    }
  };

  // no zero fill: the first product overwrites (scale_d 0), and no other
  // instruction defines the accumulators while products are in flight
  float acc[S::NW / 2];
  // this warpgroup's operands inside a stage (elements)
  const int a_off = TK == 128 ? wgi * 8 * 64 : 0;
  const int b_off = TK == 128 ? 0 : wgi * (TN / 16) * 64;

  for (int c = 0; c < STAGES - 2; ++c) load_chunk(c);
  for (int c = 0; c < nch; ++c) {
    sm90::cp_async_wait<STAGES - 3>();   // chunk c landed
    __syncthreads();   // ... for every thread; wgmma(c - 2) is done
    load_chunk(c + STAGES - 2);          // into the stage of chunk c - 2
                                         // (STAGES = 3: of chunk c + 1)
    transform(c);
    sm90::fence_proxy_async();   // u, ybar visible to wgmma
    __syncthreads();
    const unsigned char* st = stage(c);
    const bf16* us = reinterpret_cast<const bf16*>(st) + a_off;
    const bf16* ybs = reinterpret_cast<const bf16*>(st + 2 * S::X) + b_off;
    sm90::wgmma_fence();
#pragma unroll
    for (int s = 0; s < CH / 16; ++s)
      sm90::wgmma_ss<S::NW, 1, 1>(
          acc, sm90::desc(us + s * 16 * TK, 16 * TK, 128),
          sm90::desc(ybs + s * 16 * TN, 16 * TN, 128), c > 0 || s > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();   // chunk c - 1's product is done
  }
  sm90::wgmma_wait<0>();
  sm90::fence_acc<S::NW>(acc);

  // the accumulator fragment: row 16 * (warp % 4) + g (+ 8) of this
  // warpgroup's 64 rows, columns 8j + 2t, 8j + 2t + 1
  float* out = a.out + (size_t)blockIdx.z * a.K * a.N;
  const int kr = k0 + (TK == 128 ? 64 * wgi : 0) + 16 * (warp % 4) + g;
  const int nc = n0 + (TK == 128 ? 0 : wgi * (TN / 2)) + 2 * t;
#pragma unroll
  for (int j = 0; j < S::NW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(out + (size_t)(kr + 8 * h) * a.N + nc +
                                 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

bool fits(const WgradArgs<bf16>& a) {
  const void* ptrs[] = {a.dy, a.y, a.x, a.x2};
  for (const void* p : ptrs)
    if (!dl4j::aligned16(p)) return false;
  return a.M > 0 && a.K % 64 == 0 && a.N % 64 == 0;
}

template <int TK, int TN>
cudaError_t launch(const WgradArgs<bf16>& a, int nz, cudaStream_t stream) {
  const dim3 grid(a.K / TK, a.N / TN, nz);
  wgrad_wgmma_kernel<TK, TN>
      <<<grid, THREADS, Tile<TK, TN>::BYTES, stream>>>(a);
  return cudaGetLastError();
}

template <int TK, int TN>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(wgrad_wgmma_kernel<TK, TN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Tile<TK, TN>::BYTES);
}

}  // namespace wg

template <typename T>
cudaError_t launch(const void* dy, const void* y, const void* x,
                   const void* x2, const void* s1, const void* t1,
                   const void* s2, const void* t2, const void* dssum,
                   const void* dssq, void* dw, void* scratch, int M, int K,
                   int N, int splits, int relu, int route,
                   cudaStream_t stream) {
  constexpr int VEC = dl4j::VecOf<T>::N;
  if (splits < 1 || (splits > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  // rows per split: whole chunks (BK = wg::CH = 32 rows); ranges past M
  // are not launched
  int rows = (M + splits - 1) / splits;
  rows = (rows + BK - 1) / BK * BK;
  const int nz = (M + rows - 1) / rows;
  float* out = static_cast<float*>(nz > 1 ? scratch : dw);
  const WgradArgs<T> a{
      static_cast<const T*>(dy), static_cast<const T*>(y),
      static_cast<const T*>(x), static_cast<const T*>(x2),
      static_cast<const float*>(s1), static_cast<const float*>(t1),
      static_cast<const float*>(s2), static_cast<const float*>(t2),
      static_cast<const float*>(dssum), static_cast<const float*>(dssq),
      out, M, K, N, rows, relu != 0,
      K % VEC == 0 && dl4j::aligned16(x) && dl4j::aligned16(x2),
      N % VEC == 0 && dl4j::aligned16(dy) && dl4j::aligned16(y)};
  cudaError_t e;
  if (route != 0) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (!wg::fits(a)) return cudaErrorInvalidValue;
      const bool k128 = K % 128 == 0, n128 = N % 128 == 0;
      e = k128 ? (n128 ? wg::launch<128, 128>(a, nz, stream)
                       : wg::launch<128, 64>(a, nz, stream))
               : (n128 ? wg::launch<64, 128>(a, nz, stream)
                       : wg::launch<64, 64>(a, nz, stream));
    } else {
      return cudaErrorInvalidValue;   // the wgmma route is bf16 only
    }
  } else {
    const dim3 grid((K + BM - 1) / BM, (N + BN - 1) / BN, nz);
    wgrad_kernel<T><<<grid, THREADS, 0, stream>>>(a);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess || nz == 1) return e;
  const size_t len = (size_t)K * N;
  split_sum_kernel<<<(unsigned)((len + 255) / 256), 256, 0, stream>>>(
      out, nz, len, static_cast<float*>(dw));
  return cudaGetLastError();
}

}  // namespace

extern "C" {
// once, when the library is loaded: the wgmma route's blocks use more
// than 48 KB of dynamic shared memory
int dl4j_init() {
  cudaError_t e = wg::allow_smem<128, 128>();
  if (e == cudaSuccess) e = wg::allow_smem<128, 64>();
  if (e == cudaSuccess) e = wg::allow_smem<64, 128>();
  if (e == cudaSuccess) e = wg::allow_smem<64, 64>();
  return static_cast<int>(e);
}

int wgrad_conv1x1_launch(int is_bf16, const void* dy, const void* y,
                         const void* x, const void* x2, const void* s1,
                         const void* t1, const void* s2, const void* t2,
                         const void* dssum, const void* dssq, void* dw,
                         void* scratch, int M, int K, int N, int splits,
                         int relu, int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(dy, y, x, x2, s1, t1, s2, t2, dssum,
                                      dssq, dw, scratch, M, K, N, splits,
                                      relu, route, st)
              : launch<float>(dy, y, x, x2, s1, t1, s2, t2, dssum, dssq, dw,
                              scratch, M, K, N, splits, relu, route, st);
  return static_cast<int>(e);
}
}

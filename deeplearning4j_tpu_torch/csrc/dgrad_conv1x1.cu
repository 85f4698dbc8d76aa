// Fused input gradient of the 1x1 convolution for Hopper (sm_90a).
//
// Replaces the TPU kernel `dgrad_conv1x1` / `_dgrad1x1_kernel` in
// deeplearning4j_tpu/nn/helpers/pallas_conv.py (launcher :361, body :304):
//   ybar = dy + dssum + 2*y*dssq         (f32, rounded once for the product)
//   du   = ybar @ W^T [+ du_out]         (f32 accumulation)
//   du  *= (u > 0) when relu, u = x*s1 + t1 [+ x2 (*s2 + t2)] recomputed
//   dx1  = du*s1, dx2 = du*s2            (f32 product rounded once; du
//                                          itself where a branch is plain)
//   ds1 = sum(x*du), dt = sum(du), ds2 = sum(x2*du)   over M, per column
//   db  = sum(ybar) over M, per column, of the UNROUNDED f32 ybar
// dy, y [M, N]; W [K, N]; x, x2, du_out, dx1, dx2 [M, K]; s*, t* [K] f32;
// dssum, dssq [N] f32; f32 or bf16.
//
// Two routes, picked by the wrapper (pallas_conv.backward_route) from
// dtype, shape and alignment and checked again here:
//
// bf16 route (K, N multiples of 64, 16-byte aligned operands): what bounds
// it on an H100 SXM (3.35 TB/s, 989 TF/s bf16) is memory: it must read
// dy, y, x (x2, du_out) once and write dx1 (dx2), for 2*M*K*N operations,
// under the card's ridge at ResNet-50's widths. The design keeps bytes in
// flight and reads each large operand as few times as the tile allows:
//   * blocks of 128 rows x TN columns of du (TN = 128, or 64 where K is
//     not a multiple of 128), 256 threads = two warpgroups of 64 rows,
//     one block of ~225 KB per SM; the column tiles of a row tile are
//     launched side by side, so its dy/y rows come from L2 after the
//     first;
//   * the reduction over N in 32-deep chunks through a ring of 4
//     shared-memory stages filled by cp.async (16-byte copies, zero fill
//     past M): the copies of chunk i+2 are in flight while chunk i is
//     multiplied. cp.async and not TMA: the A operand is read by threads
//     (ldmatrix) to form ybar anyway, the ragged edge is a per-copy
//     predicate, and no tensor map or driver entry point is needed;
//   * du = ybar @ W^T on wgmma m64nTNk16: A = ybar from registers, each
//     thread forming its fragment from the staged dy/y (ldmatrix) in f32
//     in the plain version's order (ybar_f32) and rounding once to bf16;
//     B = W's rows straight from the stage (K-major, no transform);
//   * dy/y are read K/TN times (K/128, not K/64), mostly from L2; W once
//     per row tile; x, x2 and du_out once, their tile copied into shared
//     memory at the start so it lands during the product, and read once
//     for the relu mask (u recomputed in bf16 pairs, TileAffine::u2: the
//     forward's rounding, the same bits as TileAffine::u) and ds1/ds2;
//   * db comes from the pass that forms ybar (blocks of the first K
//     tile, the unrounded f32 ybar), column sums in a fixed tree: each
//     thread's two rows, warp shuffles, then the 8 warps in order through
//     shared memory, into per-row-tile partials ([tiles, N], 128-row
//     tiles); ds1/dt/ds2 the same way from the epilogue;
//   * dx1/dx2 are staged in shared memory and written as 16-byte vectors.
// On the H100 (700 W) this route runs at 2.2-10x its bound per call and
// 2.9x summed over a ResNet-50 train step (PERF.md): the large-M calls
// near the memory bound, the deep ones (M = 6,272, N = 2,048) held by
// each chunk's chain of copy wait, ybar, product and barrier in one block
// per SM.
//
// f32 and every other shape or pointer: the simple design of PR 2
// (64x64 tiles, 128 threads, BK = 32, mma.sync for bf16, FMA for f32;
// the f32 path must not use TF32), in conv1x1_backward.cuh.
//
// Both routes write per-row-tile partials and sum them in a fixed order
// in a second kernel: no atomics, the same bits on every run (the TPU
// kernel accumulates these sums across a sequential grid, which Hopper's
// parallel blocks do not have).
#include "conv1x1_backward.cuh"
#include "wgmma_sm90.cuh"

namespace {

using dl4j::BM;
using dl4j::BN;
using dl4j::Num;
using dl4j::THREADS;

// dgrad's B: element (out k, red n) = W[k, n], a row of W per vector
template <typename T>
struct WtOp {
  static constexpr bool RED_CONTIG = true;
  static constexpr int VEC = dl4j::VecOf<T>::N;
  const T* w;
  int K, N;
  bool vec;             // N % VEC == 0 and w 16-byte aligned

  __device__ __forceinline__ void load(int k, int n, float* v) const {
    const size_t i = (size_t)k * N + n;
    if (vec) {
      if (k < K && n < N) {
        dl4j::unpack<T>(*reinterpret_cast<const uint4*>(w + i), v);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[q] = 0.0f;
      }
      return;
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q)
      v[q] = k < K && n + q < N ? Num<T>::to_f(w[i + q]) : 0.0f;
  }
};

template <typename T>
struct DgradArgs {
  const T* dy;
  const T* y;
  const T* w;
  const T* x;
  const T* x2;          // nullptr = one branch
  const T* du_out;      // nullptr = no emitted-u cotangent
  const float* s1;      // nullptr = plain branch
  const float* t1;
  const float* s2;
  const float* t2;
  const float* dssum;   // nullptr = no statistics cotangent
  const float* dssq;
  T* dx1;
  T* dx2;
  float* partial;       // [tiles, K] x3 (ds1, dt, ds2), then [tiles, N] (db)
  int M, K, N;
  bool relu, vec;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) dgrad_kernel(DgradArgs<T> a) {
  __shared__ float Cs[BM][BN + 4];
  __shared__ dl4j::TileAffine aff;
  const int m0 = blockIdx.x * BM, k0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  aff.fill<T>(a.s1, a.t1, a.s2, a.t2, k0, a.K);   // read after the gemm's syncs
  const dl4j::YbarOp<T, true> A{a.dy, a.y, a.dssum, a.dssq, a.M, a.N, a.vec};
  const WtOp<T> B{a.w, a.K, a.N, a.vec};
  dl4j::gemm_nt<T>(A, B, m0, k0, 0, a.N, Cs);
  __syncthreads();

  const bool aff1 = a.s1 != nullptr, aff2 = a.s2 != nullptr;
  const bool has_x2 = a.x2 != nullptr;
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int m = m0 + r, k = k0 + c;
    float du = 0.0f;
    if (m < a.M && k < a.K) {
      const size_t e = (size_t)m * a.K + k;
      du = Cs[r][c];
      if (a.du_out != nullptr) du = __fadd_rn(du, Num<T>::to_f(a.du_out[e]));
      if (a.relu) {
        const float x2v = has_x2 ? Num<T>::to_f(a.x2[e]) : 0.0f;
        const float u = aff.u<T>(Num<T>::to_f(a.x[e]), aff1, has_x2, x2v,
                                 aff2, false, c);
        if (!(u > 0.0f)) du = 0.0f;
      }
      a.dx1[e] = Num<T>::from_f(aff1 ? __fmul_rn(du, aff.s1f[c]) : du);
      if (has_x2)
        a.dx2[e] = Num<T>::from_f(aff2 ? __fmul_rn(du, aff.s2f[c]) : du);
    }
    Cs[r][c] = du;   // the masked du, for the column sums
  }
  __syncthreads();

  const size_t tiles = gridDim.x;
  float* p_ds1 = a.partial;
  float* p_dt = p_ds1 + tiles * a.K;
  float* p_ds2 = p_dt + tiles * a.K;
  float* p_db = p_ds2 + tiles * a.K;
  const int rows = min(BM, a.M - m0);
  if (tid < BN) {   // dt and ds1 of column k, rows in order
    const int k = k0 + tid;
    if (k < a.K && (aff1 || aff2)) {
      float dt = 0.0f, ds = 0.0f;
      for (int r = 0; r < rows; ++r) {
        const float d = Cs[r][tid];
        dt = __fadd_rn(dt, d);
        if (aff1)
          ds = __fadd_rn(ds, __fmul_rn(
              Num<T>::to_f(a.x[(size_t)(m0 + r) * a.K + k]), d));
      }
      p_dt[blockIdx.x * (size_t)a.K + k] = dt;
      if (aff1) p_ds1[blockIdx.x * (size_t)a.K + k] = ds;
    }
  } else {          // ds2 of column k
    const int c = tid - BN, k = k0 + c;
    if (k < a.K && aff2) {
      float ds = 0.0f;
      for (int r = 0; r < rows; ++r)
        ds = __fadd_rn(ds, __fmul_rn(
            Num<T>::to_f(a.x2[(size_t)(m0 + r) * a.K + k]), Cs[r][c]));
      p_ds2[blockIdx.x * (size_t)a.K + k] = ds;
    }
  }
  if (blockIdx.y == 0) {   // db: this row tile's sums of the f32 ybar
    for (int n = tid; n < a.N; n += THREADS) {
      float s = 0.0f;
      for (int r = 0; r < rows; ++r) {
        const size_t e = (size_t)(m0 + r) * a.N + n;
        const float yv = a.dssum != nullptr ? Num<T>::to_f(a.y[e]) : 0.0f;
        s = __fadd_rn(s, dl4j::ybar_f32(Num<T>::to_f(a.dy[e]), yv, a.dssum,
                                        a.dssq, n));
      }
      p_db[blockIdx.x * (size_t)a.N + n] = s;
    }
  }
}

// ------------------------------------------------ the bf16 (wgmma) route

namespace wg {

using bf16 = __nv_bfloat16;
namespace sm90 = dl4j::sm90;
constexpr int ROWS = 128;     // rows of du per block: two warpgroups of 64
constexpr int CH = 32;        // reduction (N) chunk
constexpr int STAGES = 4;     // ring: chunks i+1, i+2 in flight during i
constexpr int THREADS = 256;
constexpr int AP = CH + 8;    // dy/y stage row pitch: conflict-free ldmatrix

// dynamic shared memory of a block with TN columns of du
template <int TN>
struct Smem {
  static constexpr int EP = TN + 8;              // epilogue tile pitch
  static constexpr int DY = ROWS * AP * 2;       // bytes of the dy stage
  static constexpr int WB = TN * CH * 2;         // W chunk, core matrices
  static constexpr int DSS = 2 * CH * 4;       // dssum, dssq of the chunk
  static constexpr int STAGE = 2 * DY + WB + DSS;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int EPI = ROWS * EP * 2;      // x, x2, du_out tiles
  static constexpr int RED = 8 * TN * 3 * 4;     // per-warp column sums
  static constexpr int AFF = sizeof(dl4j::TileAffineW<TN>);
  static constexpr int DBS = 2 * 8 * CH * 4;     // per-warp db sums, x2
  static constexpr int BYTES = RING + 3 * EPI + AFF + DBS;
  // after the product the ring holds dx1/dx2 and the column sums
  static_assert(2 * EPI + RED <= RING, "epilogue staging exceeds the ring");
  static_assert(BYTES <= 232448, "more shared memory than a block has");
};

__device__ __forceinline__ void unpack2(uint32_t v, float* f) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  f[0] = __low2float(h);
  f[1] = __high2float(h);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// fixed-order sum over the 8 row groups g of a warp (lanes t, t+4, ...)
__device__ __forceinline__ float sum_over_g(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

template <int TN>
__global__ void __launch_bounds__(THREADS, 1)
dgrad_wgmma_kernel(DgradArgs<bf16> a) {
  using S = Smem<TN>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  bf16* xs = reinterpret_cast<bf16*>(smem + S::RING);
  bf16* x2s = xs + ROWS * S::EP;
  bf16* duos = x2s + ROWS * S::EP;
  auto* aff = reinterpret_cast<dl4j::TileAffineW<TN>*>(smem + S::RING +
                                                       3 * S::EPI);
  float* dbs = reinterpret_cast<float*>(smem + S::RING + 3 * S::EPI +
                                        S::AFF);   // [2][8 warps][CH]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // the column tiles of one row tile are neighbours in launch order, so
  // its dy/y rows are re-read from L2
  const int m0 = blockIdx.y * ROWS, k0 = blockIdx.x * TN;
  const bool db_blk = blockIdx.x == 0;
  const bool stats = a.dssum != nullptr;
  const bool aff1 = a.s1 != nullptr, aff2 = a.s2 != nullptr;
  const bool has_x2 = a.x2 != nullptr, has_duo = a.du_out != nullptr;
  const bool need_x = a.relu || aff1;
  const bool need_x2 = has_x2 && (a.relu || aff2);
  const int nch = a.N / CH;
  const size_t tiles = gridDim.y;
  float* p_ds1 = a.partial;
  float* p_dt = p_ds1 + tiles * a.K;
  float* p_ds2 = p_dt + tiles * a.K;
  float* p_db = p_ds2 + tiles * a.K;

  aff->template fill<bf16>(a.s1, a.t1, a.s2, a.t2, k0, a.K);

  auto load_chunk = [&](int c) {
    if (c < nch) {
      unsigned char* st = ring + (c % STAGES) * S::STAGE;
      bf16* dys = reinterpret_cast<bf16*>(st);
      bf16* ys = reinterpret_cast<bf16*>(st + S::DY);
      bf16* ws = reinterpret_cast<bf16*>(st + 2 * S::DY);
      float* dss = reinterpret_cast<float*>(st + 2 * S::DY + S::WB);
      const int n0 = c * CH;
      if (stats && tid < CH / 2)   // 16 bytes = 4 floats a thread
        sm90::cp_async16(dss + tid * 4,
                         (tid < CH / 4 ? a.dssum : a.dssq) + n0 +
                             (tid % (CH / 4)) * 4,
                         true);
      for (int i = tid; i < ROWS * CH / 8; i += THREADS) {
        const int r = i / (CH / 8), v = i % (CH / 8);
        const bool ok = m0 + r < a.M;
        const size_t e = (size_t)(ok ? m0 + r : 0) * a.N + n0 + v * 8;
        sm90::cp_async16(dys + r * AP + v * 8, a.dy + e, ok);
        if (stats) sm90::cp_async16(ys + r * AP + v * 8, a.y + e, ok);
      }
      // W rows k0.., columns n0..: K-major core matrices, LBO 128, SBO 512
      for (int i = tid; i < TN * CH / 8; i += THREADS) {
        const int r = i / (CH / 8), v = i % (CH / 8);
        sm90::cp_async16(ws + ((r / 8) * (CH / 8) + v) * 64 + (r % 8) * 8,
                         a.w + (size_t)(k0 + r) * a.N + n0 + v * 8, true);
      }
    }
    sm90::cp_async_commit();   // possibly empty: keeps the group count
  };
  // the epilogue's tiles of x, x2 and du_out, read once
  auto load_epi = [&]() {
    for (int i = tid; i < ROWS * TN / 8; i += THREADS) {
      const int r = i / (TN / 8), v = i % (TN / 8);
      const bool ok = m0 + r < a.M;
      const size_t e = (size_t)(ok ? m0 + r : 0) * a.K + k0 + v * 8;
      const int o = r * S::EP + v * 8;
      if (need_x) sm90::cp_async16(xs + o, a.x + e, ok);
      if (need_x2) sm90::cp_async16(x2s + o, a.x2 + e, ok);
      if (has_duo) sm90::cp_async16(duos + o, a.du_out + e, ok);
    }
    sm90::cp_async_commit();
  };
  // the 8 warps' db sums of chunk c, in warp order, to the partials
  auto flush_db = [&](int c) {
    if (tid < CH) {
      const float* d = dbs + (c & 1) * 8 * CH + tid;
      float s = d[0];
#pragma unroll
      for (int w = 1; w < 8; ++w) s = __fadd_rn(s, d[w * CH]);
      p_db[blockIdx.y * (size_t)a.N + c * CH + tid] = s;
    }
  };

  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.0f;
  const int wrow = 16 * warp;   // this warp's rows (its warpgroup's 16*(warp%4))
  const bool v0 = m0 + wrow + g < a.M, v1 = m0 + wrow + g + 8 < a.M;

  for (int c = 0; c < STAGES - 2; ++c) load_chunk(c);
  load_epi();
  for (int c = 0; c < nch; ++c) {
    sm90::cp_async_wait<STAGES - 3>();   // chunk c (and earlier) landed
    sm90::fence_proxy_async();           // W chunk visible to wgmma
    __syncthreads();
    if (db_blk && c > 0) flush_db(c - 1);
    load_chunk(c + STAGES - 2);   // into the stage of chunk c - 2
    const unsigned char* st = ring + (c % STAGES) * S::STAGE;
    const bf16* dys = reinterpret_cast<const bf16*>(st);
    const bf16* ys = reinterpret_cast<const bf16*>(st + S::DY);
    const bf16* ws = reinterpret_cast<const bf16*>(st + 2 * S::DY);
    // the chunk's statistics cotangents (nullptr: none)
    const float* dss = stats ? reinterpret_cast<const float*>(
                                   st + 2 * S::DY + S::WB)
                             : nullptr;
    uint32_t af[CH / 16][4];
#pragma unroll
    for (int s = 0; s < CH / 16; ++s) {
      uint32_t d4[4], y4[4] = {0u, 0u, 0u, 0u};
      const int off = (wrow + (lane & 15)) * AP + s * 16 + (lane >> 4) * 8;
      sm90::ldmatrix_x4(d4, dys + off);
      if (stats) sm90::ldmatrix_x4(y4, ys + off);
      float yb[4][2];
      // fragment q: rows g (q even) / g + 8 (q odd), columns 2t (q < 2)
      // / 2t + 8, and the column after each
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = s * 16 + 2 * t + (q >= 2 ? 8 : 0);   // in the chunk
        const bool vr = (q & 1) ? v1 : v0;
        float dv[2], yv[2];
        unpack2(d4[q], dv);
        unpack2(y4[q], yv);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          yb[q][e] = vr ? dl4j::ybar_f32(dv[e], yv[e], dss, dss + CH, n + e)
                        : 0.0f;
        af[s][q] = pack2(yb[q][0], yb[q][1]);
      }
      if (db_blk) {   // uniform over the block
        float* d = dbs + (c & 1) * 8 * CH + warp * CH + s * 16 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v =
                sum_over_g(__fadd_rn(yb[2 * h][e], yb[2 * h + 1][e]));
            if (g == 0) d[h * 8 + e] = v;
          }
      }
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int s = 0; s < CH / 16; ++s)
      sm90::wgmma_rs<TN>(acc, af[s], sm90::desc(ws + s * 128, 128, 512));
    sm90::wgmma_commit();
    // the A fragments live in registers: the product must finish before
    // the next chunk's fragments are formed
    sm90::wgmma_wait<0>();
    sm90::fence_acc<TN>(acc);
  }
  sm90::cp_async_wait<0>();
  __syncthreads();
  if (db_blk) flush_db(nch - 1);

  // epilogue: the ring is free; dx1/dx2 and the column sums go there
  bf16* dx1s = reinterpret_cast<bf16*>(ring);
  bf16* dx2s = dx1s + ROWS * S::EP;
  float* red = reinterpret_cast<float*>(ring + 2 * S::EPI);  // [8][TN][3]
  const bool sums = aff1 || aff2;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int col = 8 * j + 2 * t;
    float sdt[2] = {0.0f, 0.0f}, sds1[2] = {0.0f, 0.0f},
          sds2[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wrow + g + 8 * h;
      const int o = r * S::EP + col;
      float du[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
      const uint32_t xp =
          need_x ? *reinterpret_cast<const uint32_t*>(xs + o) : 0u;
      const uint32_t x2p =
          need_x2 ? *reinterpret_cast<const uint32_t*>(x2s + o) : 0u;
      float xv[2], x2v[2], dov[2], u[2] = {1.0f, 1.0f};
      unpack2(xp, xv);
      unpack2(x2p, x2v);
      if (a.relu) {   // u of the pair, as the forward rounded it
        const __nv_bfloat162 u2 = aff->u2(
            *reinterpret_cast<const __nv_bfloat162*>(&xp), aff1, has_x2,
            *reinterpret_cast<const __nv_bfloat162*>(&x2p), aff2, false,
            col / 2);
        u[0] = __low2float(u2);
        u[1] = __high2float(u2);
      }
      if (has_duo) {
        unpack2(*reinterpret_cast<const uint32_t*>(duos + o), dov);
        du[0] = __fadd_rn(du[0], dov[0]);
        du[1] = __fadd_rn(du[1], dov[1]);
      }
      const bool vr = h ? v1 : v0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!(u[e] > 0.0f) || !vr) du[e] = 0.0f;
        sdt[e] = __fadd_rn(sdt[e], du[e]);
        sds1[e] = __fadd_rn(sds1[e], __fmul_rn(xv[e], du[e]));
        sds2[e] = __fadd_rn(sds2[e], __fmul_rn(x2v[e], du[e]));
      }
      *reinterpret_cast<uint32_t*>(dx1s + o) =
          aff1 ? pack2(__fmul_rn(du[0], aff->s1f[col]),
                       __fmul_rn(du[1], aff->s1f[col + 1]))
               : pack2(du[0], du[1]);
      if (has_x2)
        *reinterpret_cast<uint32_t*>(dx2s + o) =
            aff2 ? pack2(__fmul_rn(du[0], aff->s2f[col]),
                         __fmul_rn(du[1], aff->s2f[col + 1]))
                 : pack2(du[0], du[1]);
    }
    if (sums) {   // uniform over the block
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float vdt = sum_over_g(sdt[e]);
        const float v1s = sum_over_g(sds1[e]);
        const float v2s = sum_over_g(sds2[e]);
        if (g == 0) {
          float* d = red + (warp * TN + col + e) * 3;
          d[0] = v1s;
          d[1] = vdt;
          d[2] = v2s;
        }
      }
    }
  }
  __syncthreads();
  if (sums) {
    for (int col = tid; col < TN; col += THREADS) {
      float s[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) s[q] = red[col * 3 + q];
      for (int w = 1; w < 8; ++w)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          s[q] = __fadd_rn(s[q], red[(w * TN + col) * 3 + q]);
      const size_t e = blockIdx.y * (size_t)a.K + k0 + col;
      if (aff1) p_ds1[e] = s[0];
      p_dt[e] = s[1];
      if (aff2) p_ds2[e] = s[2];
    }
  }
  for (int i = tid; i < ROWS * TN / 8; i += THREADS) {
    const int r = i / (TN / 8), v = i % (TN / 8);
    if (m0 + r >= a.M) continue;
    const size_t e = (size_t)(m0 + r) * a.K + k0 + v * 8;
    const int o = r * S::EP + v * 8;
    *reinterpret_cast<uint4*>(a.dx1 + e) =
        *reinterpret_cast<const uint4*>(dx1s + o);
    if (has_x2)
      *reinterpret_cast<uint4*>(a.dx2 + e) =
          *reinterpret_cast<const uint4*>(dx2s + o);
  }
}

// the shapes and pointers this route takes
bool fits(const DgradArgs<bf16>& a) {
  const void* ptrs[] = {a.dy,  a.y,      a.w,   a.x,    a.x2,
                        a.du_out, a.dx1, a.dx2, a.dssum, a.dssq};
  for (const void* p : ptrs)
    if (!dl4j::aligned16(p)) return false;
  return a.M > 0 && a.K % 64 == 0 && a.N % 64 == 0;
}

template <int TN>
cudaError_t launch(const DgradArgs<bf16>& a, cudaStream_t stream) {
  const dim3 grid(a.K / TN, (a.M + ROWS - 1) / ROWS);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  dgrad_wgmma_kernel<TN><<<grid, THREADS, Smem<TN>::BYTES, stream>>>(a);
  return cudaGetLastError();
}

template <int TN>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(dgrad_wgmma_kernel<TN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Smem<TN>::BYTES);
}

}  // namespace wg

// the fixed-order sums of the per-row-tile partials
template <typename T>
cudaError_t sum_partials(const DgradArgs<T>& a, size_t tiles, float* ds1,
                         float* dt, float* ds2, float* db,
                         cudaStream_t stream) {
  dl4j::TileSums segs{
      {a.partial, a.partial + tiles * a.K, a.partial + 2 * tiles * a.K,
       a.partial + 3 * tiles * a.K},
      {ds1, dt, ds2, db},
      {a.K, a.K, a.K, a.N}};
  const int widest = a.K > a.N ? a.K : a.N;
  dl4j::tile_sum_kernel<<<dim3((widest + dl4j::RC - 1) / dl4j::RC, 4),
                          dim3(dl4j::RC, dl4j::RS), 0, stream>>>(
      segs, (int)tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* dy, const void* y, const void* w,
                   const void* x, const void* x2, const void* du_out,
                   const void* s1, const void* t1, const void* s2,
                   const void* t2, const void* dssum, const void* dssq,
                   void* dx1, void* dx2, void* partial, void* ds1, void* dt,
                   void* ds2, void* db, int M, int K, int N, int relu,
                   int route, cudaStream_t stream) {
  constexpr int VEC = dl4j::VecOf<T>::N;
  const bool vec = N % VEC == 0 && dl4j::aligned16(dy) &&
                   dl4j::aligned16(y) && dl4j::aligned16(w);
  const DgradArgs<T> a{
      static_cast<const T*>(dy), static_cast<const T*>(y),
      static_cast<const T*>(w), static_cast<const T*>(x),
      static_cast<const T*>(x2), static_cast<const T*>(du_out),
      static_cast<const float*>(s1), static_cast<const float*>(t1),
      static_cast<const float*>(s2), static_cast<const float*>(t2),
      static_cast<const float*>(dssum), static_cast<const float*>(dssq),
      static_cast<T*>(dx1), static_cast<T*>(dx2),
      static_cast<float*>(partial), M, K, N, relu != 0, vec};
  size_t tiles;
  cudaError_t e;
  if (route != 0) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (!wg::fits(a)) return cudaErrorInvalidValue;
      e = K % 128 == 0 ? wg::launch<128>(a, stream)
                       : wg::launch<64>(a, stream);
      tiles = (M + wg::ROWS - 1) / wg::ROWS;
    } else {
      return cudaErrorInvalidValue;   // the wgmma route is bf16 only
    }
  } else {
    const dim3 grid((M + BM - 1) / BM, (K + BN - 1) / BN);
    dgrad_kernel<T><<<grid, THREADS, 0, stream>>>(a);
    e = cudaGetLastError();
    tiles = grid.x;
  }
  if (e != cudaSuccess) return e;
  return sum_partials<T>(a, tiles, static_cast<float*>(ds1),
                         static_cast<float*>(dt), static_cast<float*>(ds2),
                         static_cast<float*>(db), stream);
}

}  // namespace

extern "C" {
// route 1 (bf16, wgmma) takes 128-row tiles, route 0 the simple kernel's
// 64: the wrapper sizes the [tiles, 3K + N] partials with it
int dl4j_dgrad_row_tile(int route) { return route ? wg::ROWS : BM; }

// once, when the library is loaded: the wgmma route's blocks use more
// than 48 KB of dynamic shared memory
int dl4j_init() {
  cudaError_t e = wg::allow_smem<128>();
  if (e == cudaSuccess) e = wg::allow_smem<64>();
  return static_cast<int>(e);
}

int dgrad_conv1x1_launch(
    int is_bf16, const void* dy, const void* y, const void* w, const void* x,
    const void* x2, const void* du_out, const void* s1, const void* t1,
    const void* s2, const void* t2, const void* dssum, const void* dssq,
    void* dx1, void* dx2, void* partial, void* ds1, void* dt, void* ds2,
    void* db, int M, int K, int N, int relu, int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(dy, y, w, x, x2, du_out, s1, t1, s2,
                                      t2, dssum, dssq, dx1, dx2, partial,
                                      ds1, dt, ds2, db, M, K, N, relu, route,
                                      st)
              : launch<float>(dy, y, w, x, x2, du_out, s1, t1, s2, t2,
                              dssum, dssq, dx1, dx2, partial, ds1, dt, ds2,
                              db, M, K, N, relu, route, st);
  return static_cast<int>(e);
}
}

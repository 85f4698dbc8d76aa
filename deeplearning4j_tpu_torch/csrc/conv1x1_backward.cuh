// Shared core of the fused 1x1 backward kernels (dgrad_conv1x1.cu,
// wgrad_conv1x1.cu): the rounding helpers both routes use (ybar_f32,
// TileAffineW), and for the "simple" route (f32, and shapes or pointers
// the bf16 "wgmma" route does not take) a 64x64 tile of C = A * B^T where
// both operands are
// produced element by element from their raw inputs (ybar from dy, y and
// the statistics cotangents; u from x, x2 and the affines), plus the
// fixed-order reductions of their per-tile partials. Built for sm_90a with
// nvcc into a shared library with a plain C interface (see
// deeplearning4j_tpu_torch/nn/helpers/kernel_build.py).
//
// An operand Op presents a [64 out x red] slice of a matrix: `load(out,
// red, v)` returns VEC = 16 bytes' worth of consecutive elements (already
// rounded to the compute dtype; 0 outside the matrix), running along the
// reduction index when Op::RED_CONTIG and along the output index
// otherwise. The three orientations the kernels need:
//   dgrad A = ybar [M, N]   out m, red n   reduction-contiguous
//   dgrad B = W^T           out k, red n   reduction-contiguous (W rows)
//   wgrad A = u^T           out k, red m   output-contiguous (rows of x)
//   wgrad B = ybar          out n, red m   output-contiguous
// `put` stores a vector into shared memory in the layout the product
// reads — whole when the vector runs along the layout's contiguous index,
// element by element (a transposed load) otherwise.
//
// The product itself is PR 1's simple design (fused_conv_common.cuh):
// bf16 on mma.sync m16n8k16 with f32 accumulation, four warps of 32x32;
// f32 on CUDA-core FMA, 8x4 outputs per thread (no TF32); the next chunk
// loaded into registers while the current one is multiplied. Rounding
// follows the TPU kernels: ybar is formed in f32 in the plain version's
// order (__fadd_rn/__fmul_rn: no fma contraction) and rounded once for
// the product; u is recomputed with the forward prologue's rounding.
#pragma once

#include "fused_conv_common.cuh"

namespace dl4j {

// ybar = dy + dssum + 2*y*dssq in f32 (dssum == nullptr: ybar = dy)
__device__ __forceinline__ float ybar_f32(float dy, float y,
                                          const float* __restrict__ dssum,
                                          const float* __restrict__ dssq,
                                          int n) {
  if (dssum == nullptr) return dy;
  return __fadd_rn(__fadd_rn(dy, dssum[n]),
                   __fmul_rn(__fmul_rn(2.0f, y), dssq[n]));
}

// ybar [M, N] rounded to T, as dgrad's A (out m, red n) or wgrad's B
// (out n, red m); the vector runs along n either way
template <typename T, bool RCONTIG>
struct YbarOp {
  static constexpr bool RED_CONTIG = RCONTIG;
  static constexpr int VEC = VecOf<T>::N;
  const T* dy;
  const T* y;
  const float* dssum;   // nullptr = no statistics cotangent
  const float* dssq;
  int M, N;
  bool vec;             // N % VEC == 0 and dy, y 16-byte aligned

  __device__ __forceinline__ void load(int out, int red, float* v) const {
    const int m = RCONTIG ? out : red, n = RCONTIG ? red : out;
    float d[VEC], yy[VEC];
    const size_t i = (size_t)m * N + n;
    if (vec) {   // the vector is all in or all out
      if (m >= M || n >= N) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[q] = 0.0f;
        return;
      }
      unpack<T>(*reinterpret_cast<const uint4*>(dy + i), d);
      if (dssum != nullptr)
        unpack<T>(*reinterpret_cast<const uint4*>(y + i), yy);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const bool in = m < M && n + q < N;
        d[q] = in ? Num<T>::to_f(dy[i + q]) : 0.0f;
        yy[q] = in && dssum != nullptr ? Num<T>::to_f(y[i + q]) : 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q)
      v[q] = m < M && n + q < N
                 ? rnd<T>(ybar_f32(d[q], yy[q], dssum, dssq, n + q))
                 : 0.0f;
  }
};

// The [C] vectors of a W-column tile of the prologue, in shared memory:
// scale/shift rounded to T (the prologue's operands) and the raw f32
// scales (dgrad's dx = du*scale)
template <int W>
struct TileAffineW {
  float s1r[W], t1r[W], s2r[W], t2r[W], s1f[W], s2f[W];
  // the rounded scale/shift again, as bf16 pairs of columns 2j, 2j + 1
  __nv_bfloat162 s1h[W / 2], t1h[W / 2], s2h[W / 2], t2h[W / 2];

  template <typename T>
  __device__ __forceinline__ void fill(const float* s1, const float* t1,
                                       const float* s2, const float* t2,
                                       int c0, int C) {
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      const int c = c0 + j;
      const bool a1 = s1 != nullptr && c < C, a2 = s2 != nullptr && c < C;
      s1f[j] = a1 ? s1[c] : 0.0f;
      s1r[j] = a1 ? rnd<T>(s1[c]) : 0.0f;
      t1r[j] = a1 ? rnd<T>(t1[c]) : 0.0f;
      s2f[j] = a2 ? s2[c] : 0.0f;
      s2r[j] = a2 ? rnd<T>(s2[c]) : 0.0f;
      t2r[j] = a2 ? rnd<T>(t2[c]) : 0.0f;
    }
    for (int j = threadIdx.x; j < W / 2; j += blockDim.x) {
      const int c = c0 + 2 * j;
      const bool a1 = s1 != nullptr && c + 1 < C;
      const bool a2 = s2 != nullptr && c + 1 < C;
      s1h[j] = __floats2bfloat162_rn(a1 ? s1[c] : 0.0f, a1 ? s1[c + 1] : 0.0f);
      t1h[j] = __floats2bfloat162_rn(a1 ? t1[c] : 0.0f, a1 ? t1[c + 1] : 0.0f);
      s2h[j] = __floats2bfloat162_rn(a2 ? s2[c] : 0.0f, a2 ? s2[c + 1] : 0.0f);
      t2h[j] = __floats2bfloat162_rn(a2 ? t2[c] : 0.0f, a2 ? t2[c + 1] : 0.0f);
    }
  }

  // u = relu?(x*s1 + t1 [+ x2 (*s2 + t2)]) of tile column j, with the
  // forward prologue's rounding points
  template <typename T>
  __device__ __forceinline__ float u(float x, bool aff1, bool has_x2,
                                     float x2, bool aff2, bool relu,
                                     int j) const {
    const float add =
        has_x2 && aff2 ? prologue<T>(x2, true, s2r[j], t2r[j], false, 0.0f,
                                     false)
                       : x2;
    return prologue<T>(x, aff1, s1r[j], t1r[j], has_x2, add, relu);
  }

  // u of the bf16 pair of columns 2j, 2j + 1, the same bits as u<bf16>:
  // a product or sum of two bf16 values is exact in f32 (or, where the
  // exponents lie 16+ apart, rounds to the larger operand either way), so
  // one bf16 rounding of it, as mul/add.rn.bf16x2 do, equals rounding the
  // f32 result. The .rn forms (_rn) keep the compiler from contracting a
  // product and a sum into one fma, which would round once, not twice.
  __device__ __forceinline__ __nv_bfloat162 u2(__nv_bfloat162 x, bool aff1,
                                               bool has_x2,
                                               __nv_bfloat162 x2, bool aff2,
                                               bool relu, int j) const {
    __nv_bfloat162 v =
        aff1 ? __hadd2_rn(__hmul2_rn(x, s1h[j]), t1h[j]) : x;
    if (has_x2)
      v = __hadd2_rn(
          v, aff2 ? __hadd2_rn(__hmul2_rn(x2, s2h[j]), t2h[j]) : x2);
    return relu ? __hmax2(v, __float2bfloat162_rn(0.0f)) : v;
  }
};
using TileAffine = TileAffineW<BN>;

// u [M, K] recomputed from x (and x2), as wgrad's A: out k, red m; the
// vector runs along k, inside the block's 64-column tile k0..k0+63
template <typename T>
struct UtOp {
  static constexpr bool RED_CONTIG = false;
  static constexpr int VEC = VecOf<T>::N;
  const T* x;
  const T* x2;          // nullptr = one branch
  const TileAffine* aff;   // the block's tile of the affines (shared)
  int M, K, k0;
  bool aff1, aff2, relu;
  bool vec;             // K % VEC == 0 and x, x2 16-byte aligned

  __device__ __forceinline__ void load(int k, int m, float* v) const {
    float xv[VEC], x2v[VEC];
    const size_t i = (size_t)m * K + k;
    if (vec) {
      if (m >= M || k >= K) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[q] = 0.0f;
        return;
      }
      unpack<T>(*reinterpret_cast<const uint4*>(x + i), xv);
      if (x2 != nullptr)
        unpack<T>(*reinterpret_cast<const uint4*>(x2 + i), x2v);
      else
#pragma unroll
        for (int q = 0; q < VEC; ++q) x2v[q] = 0.0f;
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const bool in = m < M && k + q < K;
        xv[q] = in ? Num<T>::to_f(x[i + q]) : 0.0f;
        x2v[q] = in && x2 != nullptr ? Num<T>::to_f(x2[i + q]) : 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q)
      v[q] = m < M && k + q < K
                 ? aff->u<T>(xv[q], aff1, x2 != nullptr, x2v[q], aff2,
                             relu, k + q - k0)
                 : 0.0f;
  }
};

// store one VEC vector of operand values (out, red) at S[out*SO + red*SR]
template <typename T, int SO, int SR, bool ALONG_RED>
__device__ __forceinline__ void put(T* S, int out, int red, const float* v) {
  constexpr int VEC = VecOf<T>::N;
  if constexpr (ALONG_RED ? SR == 1 : SO == 1) {
    *reinterpret_cast<uint4*>(S + out * SO + red * SR) = pack<T>(v);
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q)
      S[(out + (ALONG_RED ? 0 : q)) * SO + (red + (ALONG_RED ? q : 0)) * SR] =
          Num<T>::from_f(v[q]);
  }
}

// one operand's share of a [64 out x BK red] chunk: NV vectors a thread
template <typename T, typename Op>
struct OpStage {
  static constexpr int VEC = VecOf<T>::N;
  static constexpr int PER = Op::RED_CONTIG ? BK / VEC : BM / VEC;
  static constexpr int NV = BM * BK / VEC / THREADS;
  float v[NV][VEC];

  __device__ __forceinline__ static void at(int j, int& out, int& red) {
    const int i = threadIdx.x + j * THREADS;
    if (Op::RED_CONTIG) {
      out = i / PER;
      red = (i % PER) * VEC;
    } else {
      red = i / PER;
      out = (i % PER) * VEC;
    }
  }

  // the chunk at (out0, red0); reduction indices >= red_end read as 0
  __device__ __forceinline__ void load(const Op& op, int out0, int red0,
                                       int red_end) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      int o, r;
      at(j, o, r);
      if (red0 + r < red_end) {
        op.load(out0 + o, red0 + r, v[j]);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[j][q] = 0.0f;
      }
    }
  }

  template <int SO, int SR>
  __device__ __forceinline__ void store(T* S) const {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      int o, r;
      at(j, o, r);
      put<T, SO, SR, Op::RED_CONTIG>(S, o, r, v[j]);
    }
  }
};

// Cs[64][64] = sum over red in [r0, r1) of A(a0 + i, red) * B(b0 + j, red)
// f32: CUDA-core FMA; As [out][red], Bs [red][out]
template <typename OpA, typename OpB>
__device__ void gemm_nt_f32(const OpA& A, const OpB& B, int a0, int b0,
                            int r0, int r1, float (*Cs)[BN + 4]) {
  __shared__ __align__(16) float As[BM][BK + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  OpStage<float, OpA> sa;
  OpStage<float, OpB> sb;
  sa.load(A, a0, r0, r1);
  sb.load(B, b0, r0, r1);
  sa.template store<BK + 4, 1>(&As[0][0]);
  sb.template store<1, BN>(&Bs[0][0]);
  __syncthreads();
  for (int k0 = r0; k0 < r1; k0 += BK) {
    const bool more = k0 + BK < r1;
    if (more) {
      sa.load(A, a0, k0 + BK, r1);
      sb.load(B, b0, k0 + BK, r1);
    }
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[tr * 8 + i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tc * 4 + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      sa.template store<BK + 4, 1>(&As[0][0]);
      sb.template store<1, BN>(&Bs[0][0]);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[tr * 8 + i][tc * 4 + j] = acc[i][j];
}

// bf16: mma.sync on the tensor cores; As [out][red], Bt [out][red]
template <typename OpA, typename OpB>
__device__ void gemm_nt_bf16(const OpA& A, const OpB& B, int a0, int b0,
                             int r0, int r1, float (*Cs)[BN + 4]) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + APAD];
  __shared__ __align__(16) __nv_bfloat16 Bt[BN][BK + APAD];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 2, wn = warp % 2;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;
  OpStage<__nv_bfloat16, OpA> sa;
  OpStage<__nv_bfloat16, OpB> sb;
  sa.load(A, a0, r0, r1);
  sb.load(B, b0, r0, r1);
  sa.template store<BK + APAD, 1>(&As[0][0]);
  sb.template store<BK + APAD, 1>(&Bt[0][0]);
  __syncthreads();
  for (int k0 = r0; k0 < r1; k0 += BK) {
    const bool more = k0 + BK < r1;
    if (more) {
      sa.load(A, a0, k0 + BK, r1);
      sb.load(B, b0, k0 + BK, r1);
    }
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int kc = ks * 16 + 2 * t;
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int rr = wm * 32 + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[rr][kc]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[rr + 8][kc]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[rr][kc + 8]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[rr + 8][kc + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int nr = wn * 32 + ni * 8 + g;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(&Bt[nr][kc]);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(&Bt[nr][kc + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
    if (more) {
      sa.template store<BK + APAD, 1>(&As[0][0]);
      sb.template store<BK + APAD, 1>(&Bt[0][0]);
      __syncthreads();
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm * 32 + mi * 16 + g;
      const int c = wn * 32 + ni * 8 + 2 * t;
      Cs[r][c] = acc[mi][ni][0];
      Cs[r][c + 1] = acc[mi][ni][1];
      Cs[r + 8][c] = acc[mi][ni][2];
      Cs[r + 8][c + 1] = acc[mi][ni][3];
    }
}

template <typename T, typename OpA, typename OpB>
__device__ __forceinline__ void gemm_nt(const OpA& A, const OpB& B, int a0,
                                        int b0, int r0, int r1,
                                        float (*Cs)[BN + 4]) {
  if constexpr (std::is_same<T, float>::value)
    gemm_nt_f32(A, B, a0, b0, r0, r1, Cs);
  else
    gemm_nt_bf16(A, B, a0, b0, r0, r1, Cs);
}

// out[c] = fixed-order sum over tiles of p[t * n + c], for up to four
// [tiles, n] segments (grid.y); a segment with out == nullptr is skipped.
// Block (RC columns, RS tile slices) as stats_reduce_kernel: each thread
// sums every RS-th tile in order, then a fixed tree over the slices.
struct TileSums {
  const float* p[4];
  float* out[4];
  int n[4];
};

__global__ void __launch_bounds__(RC * RS)
tile_sum_kernel(TileSums segs, int tiles) {
  const int seg = blockIdx.y;
  float* out = segs.out[seg];
  if (out == nullptr) return;   // uniform over the block
  __shared__ float sh[RS][RC];
  const int n = segs.n[seg];
  const int col = blockIdx.x * RC + threadIdx.x;
  const float* p = segs.p[seg] + col;
  float s = 0.0f;
  if (col < n) {
#pragma unroll 4
    for (int t = threadIdx.y; t < tiles; t += RS) s += p[(size_t)t * n];
  }
  sh[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  for (int stride = RS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.y < stride)
      sh[threadIdx.y][threadIdx.x] += sh[threadIdx.y + stride][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && col < n) out[col] = sh[0][threadIdx.x];
}

}  // namespace dl4j

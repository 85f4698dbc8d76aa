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
// Design: blocks of 64 rows x 64 columns of du (grid M/64 x K/64), each
// reducing over N in 32-deep chunks with ybar formed in the A prologue and
// W rows as the B operand (conv1x1_backward.cuh). The epilogue adds du_out,
// applies the relu mask from u recomputed with the forward prologue's
// rounding (so the mask cannot flip at u == 0 against the plain version),
// writes dx1/dx2, and reduces its column sums over its 64 rows in a fixed
// order into per-row-tile partials [tiles, K] of ds1, dt, ds2; the blocks
// of the first column tile also sum ybar over their rows for all N into
// [tiles, N] partials of db. A second kernel sums the partials over row
// tiles in a fixed order: no atomics, the same bits on every run (the TPU
// kernel accumulates these sums across a sequential grid, which Hopper's
// parallel blocks do not have).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TF/s bf16): it reads dy, y, x
// (and x2, du_out) once and writes dx1 (dx2), for 2*M*K*N operations; at
// ResNet-50's shapes (K, N in 64..2048) mostly bound by memory, like the
// forward. This simple version re-reads dy/y once per 64-column tile of K
// (mostly from L2) and the x tile for the column sums, and keeps PR 1's
// latency limits (one chunk of register prefetch, no TMA/wgmma).
#include "conv1x1_backward.cuh"

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

template <typename T>
cudaError_t run(const DgradArgs<T>& a, float* ds1, float* dt, float* ds2,
                float* db, cudaStream_t stream) {
  const dim3 grid((a.M + BM - 1) / BM, (a.K + BN - 1) / BN);
  dgrad_kernel<T><<<grid, THREADS, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t tiles = grid.x;
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
                   cudaStream_t stream) {
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
  return run<T>(a, static_cast<float*>(ds1), static_cast<float*>(dt),
                static_cast<float*>(ds2), static_cast<float*>(db), stream);
}

}  // namespace

extern "C" int dgrad_conv1x1_launch(
    int is_bf16, const void* dy, const void* y, const void* w, const void* x,
    const void* x2, const void* du_out, const void* s1, const void* t1,
    const void* s2, const void* t2, const void* dssum, const void* dssq,
    void* dx1, void* dx2, void* partial, void* ds1, void* dt, void* ds2,
    void* db, int M, int K, int N, int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(dy, y, w, x, x2, du_out, s1, t1, s2,
                                      t2, dssum, dssq, dx1, dx2, partial,
                                      ds1, dt, ds2, db, M, K, N, relu, st)
              : launch<float>(dy, y, w, x, x2, du_out, s1, t1, s2, t2,
                              dssum, dssq, dx1, dx2, partial, ds1, dt, ds2,
                              db, M, K, N, relu, st);
  return static_cast<int>(e);
}

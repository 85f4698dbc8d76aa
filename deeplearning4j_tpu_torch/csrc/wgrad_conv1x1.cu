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
// dW contracts over M, so the output has few tiles (one 64x64 tile at
// K = N = 64) while M is large (401,408 rows at ResNet-50's first stage,
// batch 128). The TPU kernel accumulates dW across its sequential grid;
// here M is split into `splits` ranges of whole 32-row chunks, one block
// per (64x64 tile of dW, range) computes that range's partial in f32 into
// a [splits, K, N] scratch, and a second kernel sums the ranges in a fixed
// order (no atomics: the same bits on every run). The wrapper sizes
// `splits` (pallas_conv.wgrad_splits) for about four blocks per SM while
// keeping the scratch small where K*N is large (512*2048 at the last
// stage). Both operands run along M in memory, so u^T and ybar are
// transposed loads into shared memory (conv1x1_backward.cuh), with u and
// ybar recomputed as they are loaded.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TF/s bf16): it reads dy, y, x
// (and x2) once and writes dW once in f32, for 2*M*K*N operations; mostly
// bound by memory at ResNet-50's shapes. This simple version re-reads x
// once per 64-column tile of N and dy/y once per 64-row tile of K (mostly
// from L2), with PR 1's latency limits (one chunk of register prefetch,
// no TMA/wgmma).
#include "conv1x1_backward.cuh"

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

template <typename T>
cudaError_t launch(const void* dy, const void* y, const void* x,
                   const void* x2, const void* s1, const void* t1,
                   const void* s2, const void* t2, const void* dssum,
                   const void* dssq, void* dw, void* scratch, int M, int K,
                   int N, int splits, int relu, cudaStream_t stream) {
  constexpr int VEC = dl4j::VecOf<T>::N;
  if (splits < 1 || (splits > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  // rows per split: whole chunks; ranges past M are not launched
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
  const dim3 grid((K + BM - 1) / BM, (N + BN - 1) / BN, nz);
  wgrad_kernel<T><<<grid, THREADS, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nz == 1) return e;
  const size_t len = (size_t)K * N;
  split_sum_kernel<<<(unsigned)((len + 255) / 256), 256, 0, stream>>>(
      out, nz, len, static_cast<float*>(dw));
  return cudaGetLastError();
}

}  // namespace

extern "C" int wgrad_conv1x1_launch(int is_bf16, const void* dy,
                                    const void* y, const void* x,
                                    const void* x2, const void* s1,
                                    const void* t1, const void* s2,
                                    const void* t2, const void* dssum,
                                    const void* dssq, void* dw,
                                    void* scratch, int M, int K, int N,
                                    int splits, int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(dy, y, x, x2, s1, t1, s2, t2, dssum,
                                      dssq, dw, scratch, M, K, N, splits,
                                      relu, st)
              : launch<float>(dy, y, x, x2, s1, t1, s2, t2, dssum, dssq, dw,
                              scratch, M, K, N, splits, relu, st);
  return static_cast<int>(e);
}

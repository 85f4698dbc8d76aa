// Shared core of the fused convolution kernels (fused_conv1x1.cu,
// fused_conv3x3.cu): a tiled matrix product whose A operand is produced
// by a per-element prologue, with a bias/rounding/channel-statistics
// epilogue. Built for sm_90a with nvcc into a shared library with a plain
// C interface (see deeplearning4j_tpu_torch/nn/helpers/kernel_build.py).
//
// Design (first, simple version — right before fast):
//   * One block computes a [BM, BN] tile of y = A @ W with 128 threads.
//     A [BM, BK] chunks are produced by the Loader (the prologue: affine,
//     residual add, relu, zero padding for 3x3) while they are copied into
//     shared memory; W [BK, BN] chunks stream beside them.
//   * A Loader provides row_info(row) (once per block), column(kk0) (once
//     per thread and chunk, for 16 bytes of consecutive columns),
//     load(row, RowInfo, Col, out[]) -> prologued values (0 outside the
//     matrix or the image), emit(row, Col, values[]), and `vec` (whether
//     16-byte accesses are legal for these shapes and pointers).
//   * bf16: mma.sync m16n8k16 (bf16 x bf16 -> f32) on the tensor cores,
//     four warps in a 2x2 arrangement of 32x32 warp tiles.
//     f32: plain FMA on the CUDA cores, 8x4 outputs per thread (no TF32:
//     the f32 path must agree with an f32 reference).
//   * Epilogue: f32 accumulators go through a shared [BM, BN] tile, get
//     the bias, are rounded to the compute dtype and stored; the per-column
//     sum and sum of squares of the ROUNDED values over the block's rows
//     are written to a [2, row_tiles, N] f32 scratch in a fixed order.
//   * A second small kernel reduces the scratch over row tiles, again in a
//     fixed order. No atomics: results are deterministic run to run.
//
// Rounding points follow the TPU kernels (pallas_conv.py): scale/shift are
// rounded to the compute dtype, and x*scale, +shift, +add are each rounded
// to the compute dtype (__fmul_rn/__fadd_rn keep nvcc from contracting
// them into one fma, which would round once instead of twice).
//
// Loads of chunk k+1 go to registers while chunk k is multiplied out of
// shared memory with 16-byte global accesses; each thread decodes its
// chunk column vector once (scale/shift, 3x3 tap) and each block decodes
// its rows once (3x3 input position).
//
// What this design leaves on the table (later PRs): no cp.async/TMA (the
// register prefetch hides one chunk of latency, no more), no wgmma, a
// shared-memory round trip for the epilogue, bank conflicts on the
// transposed W store, 64x64 tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dl4j {

constexpr int BM = 64;        // rows (B*H*W positions) per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // reduction chunk
constexpr int THREADS = 128;
constexpr int APAD = 8;       // bf16 smem row padding (keeps 4-byte alignment)

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
};

// round a float to the compute dtype T and back
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return Num<T>::to_f(Num<T>::from_f(v));
}

// u = relu?(round(round(x*s) + t) [+ a]); s and t already rounded to T
template <typename T>
__device__ __forceinline__ float prologue(float x, bool affine, float s,
                                          float t, bool has_add, float a,
                                          bool relu) {
  float v = x;
  if (affine) {
    v = rnd<T>(__fmul_rn(v, s));
    v = rnd<T>(__fadd_rn(v, t));
  }
  if (has_add) v = rnd<T>(__fadd_rn(v, a));
  if (relu) v = fmaxf(v, 0.0f);
  return v;
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Per-row facts a loader may precompute once per block (3x3: the output
// position and the input offset of the row; 1x1 does not use them).
struct RowInfo {
  long long base;   // element offset of (b, h, w, 0) in x
  int h, w;         // h < 0 marks a row past M
};

// true for nullptr too (an absent operand constrains nothing)
__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// 16 bytes of T: the unit of every global load and store of the staging
template <typename T>
struct VecOf {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* out) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int q = 0; q < VecOf<T>::N; ++q) out[q] = Num<T>::to_f(e[q]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* in) {
  uint4 v;
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int q = 0; q < VecOf<T>::N; ++q) e[q] = Num<T>::from_f(in[q]);
  return v;
}

// Chunk staging shared by both compute paths. A thread produces VEC = 16
// bytes' worth of consecutive A columns (one chunk column vector kv) for
// rows tid / KV + j * A_ROW_STEP, and VEC consecutive W columns for rows
// tid / NV + j * B_ROW_STEP: per chunk it decodes its column vector once
// (scale/shift, 3x3 tap) and walks rows with 16-byte loads. The next
// chunk is loaded into registers while the current one is multiplied out
// of shared memory. Loaders with `vec` false (a dimension not a multiple
// of VEC, or a pointer not 16-byte aligned) fall back to scalar loads.
template <typename T, typename Loader>
struct Stage {
  static constexpr int VEC = VecOf<T>::N;           // bf16 8, f32 4
  static constexpr int KV = BK / VEC;                // vectors per A row
  static constexpr int A_VECS = BM * KV / THREADS;   // per thread
  static constexpr int A_ROW_STEP = THREADS / KV;
  static constexpr int NV = BN / VEC;                // vectors per W row
  static constexpr int B_VECS = BK * NV / THREADS;
  static constexpr int B_ROW_STEP = THREADS / NV;

  float a[A_VECS][VEC];
  uint4 b[B_VECS];

  __device__ __forceinline__ void load(const Loader& ld,
                                       const T* __restrict__ w,
                                       const RowInfo* rows, int K, int N,
                                       int m0, int n0, int k0,
                                       bool emit_blk) {
    const int tid = threadIdx.x;
    const int kv = tid % KV, r0 = tid / KV;
    const typename Loader::Col col = ld.column(k0 + kv * VEC);
#pragma unroll
    for (int j = 0; j < A_VECS; ++j) {
      const int r = r0 + j * A_ROW_STEP;
      ld.load(m0 + r, rows[r], col, a[j]);
      if (emit_blk) ld.emit(m0 + r, col, a[j]);
    }
    const int nn = n0 + (tid % NV) * VEC, kr0 = tid / NV;
#pragma unroll
    for (int j = 0; j < B_VECS; ++j) {
      const int kk = k0 + kr0 + j * B_ROW_STEP;
      const T* src = w + (size_t)kk * N + nn;
      if (ld.vec) {   // N % VEC == 0: the vector is all in or all out
        b[j] = (kk < K && nn < N) ? *reinterpret_cast<const uint4*>(src)
                                  : make_uint4(0, 0, 0, 0);
      } else {
        T* e = reinterpret_cast<T*>(&b[j]);
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          e[q] = (kk < K && nn + q < N) ? src[q] : Num<T>::from_f(0.0f);
      }
    }
  }
};

// f32 path: CUDA-core FMA, each thread an 8x4 patch of the 64x64 tile
template <typename Loader>
__device__ void gemm_f32(const Loader& ld, const float* __restrict__ w,
                         const RowInfo* rows, int K, int N, int m0, int n0,
                         bool emit_blk, float (*Cs)[BN + 4]) {
  __shared__ __align__(16) float As[BM][BK];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  using S = Stage<float, Loader>;
  S st;
  auto store = [&]() {
    const int kv = tid % S::KV, r0 = tid / S::KV;
    const int nv = tid % S::NV, kr0 = tid / S::NV;
#pragma unroll
    for (int j = 0; j < S::A_VECS; ++j)
      *reinterpret_cast<float4*>(&As[r0 + j * S::A_ROW_STEP][kv * 4]) =
          make_float4(st.a[j][0], st.a[j][1], st.a[j][2], st.a[j][3]);
#pragma unroll
    for (int j = 0; j < S::B_VECS; ++j)
      *reinterpret_cast<uint4*>(&Bs[kr0 + j * S::B_ROW_STEP][nv * 4]) =
          st.b[j];
  };
  st.load(ld, w, rows, K, N, m0, n0, 0, emit_blk);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) st.load(ld, w, rows, K, N, m0, n0, k0 + BK, emit_blk);
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
      store();
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[tr * 8 + i][tc * 4 + j] = acc[i][j];
}

// bf16 path: mma.sync on the tensor cores, f32 accumulation
template <typename Loader>
__device__ void gemm_bf16(const Loader& ld,
                          const __nv_bfloat16* __restrict__ w,
                          const RowInfo* rows, int K, int N, int m0, int n0,
                          bool emit_blk, float (*Cs)[BN + 4]) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + APAD];
  __shared__ __align__(16) __nv_bfloat16 Bt[BN][BK + APAD];  // W^T chunk
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

  using S = Stage<__nv_bfloat16, Loader>;
  S st;
  auto store = [&]() {
    const int kv = tid % S::KV, r0 = tid / S::KV;
    const int nv = tid % S::NV, kr0 = tid / S::NV;
#pragma unroll
    for (int j = 0; j < S::A_VECS; ++j)   // exact: the values are bf16
      *reinterpret_cast<uint4*>(&As[r0 + j * S::A_ROW_STEP][kv * 8]) =
          pack<__nv_bfloat16>(st.a[j]);
#pragma unroll
    for (int j = 0; j < S::B_VECS; ++j) {
      const __nv_bfloat16* e =
          reinterpret_cast<const __nv_bfloat16*>(&st.b[j]);
#pragma unroll
      for (int q = 0; q < 8; ++q) Bt[nv * 8 + q][kr0 + j * S::B_ROW_STEP] = e[q];
    }
  };
  st.load(ld, w, rows, K, N, m0, n0, 0, emit_blk);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) st.load(ld, w, rows, K, N, m0, n0, k0 + BK, emit_blk);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int kc = ks * 16 + 2 * t;
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r0 = wm * 32 + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r0][kc]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r0 + 8][kc]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r0][kc + 8]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r0 + 8][kc + 8]);
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
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
    if (more) {
      store();
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

// y[M, N] = Loader-produced A[M, K] @ w[K, N] + bias, plus per-row-tile
// column sums / sums of squares of the rounded y in partial[2][tiles][N]
// (partial == nullptr: no statistics, and no reduce launch)
template <typename T, typename Loader>
__global__ void __launch_bounds__(THREADS)
fused_gemm_kernel(Loader ld, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ partial, int M, int K, int N) {
  __shared__ float Cs[BM][BN + 4];
  __shared__ RowInfo rows[BM];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool emit_blk = blockIdx.y == 0;   // first N-tile writes u
  const int tid = threadIdx.x;
  if (tid < BM) rows[tid] = ld.row_info(m0 + tid);
  __syncthreads();
  if constexpr (std::is_same<T, float>::value) {
    gemm_f32(ld, w, rows, K, N, m0, n0, emit_blk, Cs);
  } else {
    gemm_bf16(ld, w, rows, K, N, m0, n0, emit_blk, Cs);
  }
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int row = m0 + r, col = n0 + c;
    float v = 0.0f;
    if (row < M && col < N) {
      const float a = Cs[r][c] + (bias != nullptr ? bias[col] : 0.0f);
      const T yt = Num<T>::from_f(a);
      y[(size_t)row * N + col] = yt;
      v = Num<T>::to_f(yt);
    }
    Cs[r][c] = v;
  }
  if (partial == nullptr) return;   // no statistics asked for (uniform)
  __syncthreads();
  const size_t tiles = gridDim.x;
  if (tid < BN) {
    const int col = n0 + tid;
    float s = 0.0f;
    for (int r = 0; r < BM; ++r) s = __fadd_rn(s, Cs[r][tid]);
    if (col < N) partial[(size_t)blockIdx.x * N + col] = s;
  } else if (tid < 2 * BN) {
    const int c = tid - BN, col = n0 + c;
    float q = 0.0f;
    for (int r = 0; r < BM; ++r) {
      const float v = Cs[r][c];
      q = __fadd_rn(q, __fmul_rn(v, v));
    }
    if (col < N) partial[(tiles + blockIdx.x) * N + col] = q;
  }
}

// ssum[n] / ssq[n] = fixed-order sums of partial[0 / 1][:, n].
// block (RC columns, RS row-tile slices), grid (ceil(N/RC), 2): each
// thread sums every RS-th row tile in order, then a fixed tree over the
// slices — the same order on every run, no atomics.
constexpr int RC = 8, RS = 128;

__global__ void __launch_bounds__(RC * RS)
stats_reduce_kernel(const float* __restrict__ partial, int tiles, int N,
                    float* __restrict__ ssum, float* __restrict__ ssq) {
  __shared__ float sh[RS][RC];
  const int col = blockIdx.x * RC + threadIdx.x;
  const int which = blockIdx.y;
  const float* p = partial + (size_t)which * tiles * N + col;
  float s = 0.0f;
  if (col < N) {
#pragma unroll 4
    for (int t = threadIdx.y; t < tiles; t += RS) s += p[(size_t)t * N];
  }
  sh[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  for (int stride = RS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.y < stride)
      sh[threadIdx.y][threadIdx.x] += sh[threadIdx.y + stride][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && col < N) (which == 0 ? ssum : ssq)[col] = sh[0][threadIdx.x];
}

// ssum/ssq from the [2, tiles, N] partials: the fixed-order second pass
// of both routes
inline cudaError_t reduce_stats(const float* partial, int tiles, int N,
                                float* ssum, float* ssq, cudaStream_t stream) {
  stats_reduce_kernel<<<dim3((N + RC - 1) / RC, 2), dim3(RC, RS), 0,
                        stream>>>(partial, tiles, N, ssum, ssq);
  return cudaGetLastError();
}

template <typename T, typename Loader>
cudaError_t launch_fused_gemm(const Loader& ld, const T* w, const float* bias,
                              T* y, float* partial, float* ssum, float* ssq,
                              int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  fused_gemm_kernel<T, Loader><<<grid, THREADS, 0, stream>>>(
      ld, w, bias, y, partial, M, K, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || partial == nullptr) return e;
  return reduce_stats(partial, (int)grid.x, N, ssum, ssq, stream);
}

}  // namespace dl4j

extern "C" {
const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
}

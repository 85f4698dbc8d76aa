// Fused 1x1 convolution for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_conv1x1` / `_conv1x1_kernel` in
// deeplearning4j_tpu/nn/helpers/pallas_conv.py (launcher :95, body :65):
//   u = relu?(scale*x + shift [+ add])          (prologue, per A element)
//   y = u @ W + b, f32 accumulation rounded to x's dtype
//   ssum/ssq = per-column sums of the ROUNDED y (f32)
//   u written out when emit_u (by the blocks of the first N tile)
// x [M, K] rows of an NHWC activation (M = B*H*W), W [K, N], b [N] f32,
// scale/shift [K] f32, add [M, K]; f32 or bf16.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TF/s bf16): these ResNet-50 shapes
// have K, N in 64..2048, so intensity 2*K*N/(2*(K+N)) is 26..410
// FLOP/byte: most are bound by memory. Example: [B*56^2, 64] -> 256 at
// B=32 moves ~64 MB (x 12.8 MB, y 51 MB) for 3.3 GFLOP: ~19 us of
// memory against ~3.3 us of tensor-core math. The design keeps u out of
// device memory (the prologue runs on the A chunk in shared memory) and
// the statistics pass out of it (epilogue), so each big tensor moves once.
// What it leaves on the table is listed in fused_conv_common.cuh; the
// main ones: one chunk of prefetch is all the latency hiding there is,
// and x is re-read once per N tile (N/64 times, mostly from L2). On the
// H100 it runs at 5-40x its bound per call (PERF.md).
#include "fused_conv_common.cuh"

namespace {

template <typename T>
struct Conv1x1Loader {
  static constexpr int VEC = dl4j::VecOf<T>::N;
  const T* x;
  const float* scale;   // nullptr = no affine
  const float* shift;
  const T* add;         // nullptr = no residual term
  T* u;                 // nullptr = do not emit u
  int M, K;
  bool relu;
  bool vec;             // K, N multiples of VEC and 16-byte aligned tensors

  struct Col {
    int kk;             // first of VEC consecutive columns
    float s[VEC], t[VEC];   // scale/shift rounded to T
  };

  __device__ __forceinline__ dl4j::RowInfo row_info(int) const {
    return dl4j::RowInfo{0, 0, 0};
  }

  __device__ __forceinline__ Col column(int kk) const {
    Col c;
    c.kk = kk;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const bool on = scale != nullptr && kk + q < K;
      c.s[q] = on ? dl4j::rnd<T>(scale[kk + q]) : 0.0f;
      c.t[q] = on ? dl4j::rnd<T>(shift[kk + q]) : 0.0f;
    }
    return c;
  }

  __device__ __forceinline__ void load(int row, const dl4j::RowInfo&,
                                       const Col& c, float* out) const {
    float xv[VEC], av[VEC];
    const size_t i = (size_t)row * K + c.kk;
    if (vec) {   // K % VEC == 0: the vector is all in or all out
      const bool in = row < M && c.kk < K;
      const uint4 z = make_uint4(0, 0, 0, 0);
      dl4j::unpack<T>(in ? *reinterpret_cast<const uint4*>(x + i) : z, xv);
      dl4j::unpack<T>(in && add != nullptr
                          ? *reinterpret_cast<const uint4*>(add + i) : z, av);
      if (!in) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) out[q] = 0.0f;
        return;
      }
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const bool in = row < M && c.kk + q < K;
        xv[q] = in ? dl4j::Num<T>::to_f(x[i + q]) : 0.0f;
        av[q] = in && add != nullptr ? dl4j::Num<T>::to_f(add[i + q]) : 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const bool in = row < M && c.kk + q < K;
      out[q] = in ? dl4j::prologue<T>(xv[q], scale != nullptr, c.s[q],
                                      c.t[q], add != nullptr, av[q], relu)
                  : 0.0f;
    }
  }

  __device__ __forceinline__ void emit(int row, const Col& c,
                                       const float* v) const {
    if (u == nullptr || row >= M) return;
    const size_t i = (size_t)row * K + c.kk;
    if (vec) {
      if (c.kk < K) *reinterpret_cast<uint4*>(u + i) = dl4j::pack<T>(v);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        if (c.kk + q < K) u[i + q] = dl4j::Num<T>::from_f(v[q]);
    }
  }
};

template <typename T>
cudaError_t run(const void* x, const void* w, const void* b,
                const void* scale, const void* shift, const void* add,
                void* y, void* partial, void* ssum, void* ssq, void* u,
                int M, int K, int N, int relu, cudaStream_t stream) {
  constexpr int VEC = dl4j::VecOf<T>::N;
  const bool vec = K % VEC == 0 && N % VEC == 0 &&
                   dl4j::aligned16(x) && dl4j::aligned16(w) &&
                   dl4j::aligned16(add) && dl4j::aligned16(u);
  Conv1x1Loader<T> ld{static_cast<const T*>(x),
                      static_cast<const float*>(scale),
                      static_cast<const float*>(shift),
                      static_cast<const T*>(add), static_cast<T*>(u),
                      M, K, relu != 0, vec != 0};
  return dl4j::launch_fused_gemm<T>(
      ld, static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), static_cast<float*>(partial),
      static_cast<float*>(ssum), static_cast<float*>(ssq), M, K, N, stream);
}

}  // namespace

extern "C" int fused_conv1x1_launch(int is_bf16, const void* x, const void* w,
                                    const void* b, const void* scale,
                                    const void* shift, const void* add,
                                    void* y, void* partial, void* ssum,
                                    void* ssq, void* u, int M, int K, int N,
                                    int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      is_bf16 ? run<__nv_bfloat16>(x, w, b, scale, shift, add, y, partial,
                                   ssum, ssq, u, M, K, N, relu, st)
              : run<float>(x, w, b, scale, shift, add, y, partial, ssum, ssq,
                           u, M, K, N, relu, st);
  return static_cast<int>(e);
}

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
// Implicit GEMM with K = 9*C: the A element for output row (b, h, w) and
// column (tap, c) is the prologued input at (h+dh-1, w+dw-1, c), read
// straight from x (im2col is never built in device memory); W reshaped
// [9C, N] is the B operand in HWIO order, tap-major.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TF/s bf16), ResNet-50 shapes at
// B=32: every stage is 2*M*9C*N = 7.4 GFLOP (math ~7.5 us). 56^2*64 -> 64
// moves ~26 MB (bytes ~7.7 us), so it sits on the ridge; 28^2*128 moves
// ~13 MB, 7^2*512 ~8 MB: operations dominate from 28^2 on.
// The simple design re-reads each input element up to 9 times (through
// L1/L2): rows decode their (h, w) once per block and each thread its tap
// once per chunk, then loads 16 bytes of channels per access. A later
// version would stage a haloed row tile in shared memory (TMA) and run
// wgmma.
#include "fused_conv_common.cuh"

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

}  // namespace

extern "C" int fused_conv3x3_launch(int is_bf16, const void* x, const void* w,
                                    const void* b, const void* scale,
                                    const void* shift, void* y, void* partial,
                                    void* ssum, void* ssq, int B, int H,
                                    int W, int C, int N, int relu,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      is_bf16 ? run<__nv_bfloat16>(x, w, b, scale, shift, y, partial, ssum,
                                   ssq, B, H, W, C, N, relu, st)
              : run<float>(x, w, b, scale, shift, y, partial, ssum, ssq, B,
                           H, W, C, N, relu, st);
  return static_cast<int>(e);
}

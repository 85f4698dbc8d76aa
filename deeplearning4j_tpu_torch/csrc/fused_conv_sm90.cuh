// Shared core of the fused forward kernels' bf16 "wgmma" route
// (fused_conv1x1.cu, fused_conv3x3.cu): the prologue's affine in bf16
// pairs, the W ring's stage layout, the per-chunk warpgroup product and
// the epilogue (bias, one rounding, 16-byte stores of y, fixed-order
// channel statistics of the rounded y). Needs sm_90a.
//
// A block is WGS warpgroups (128 threads each) over 64 output rows each
// and one BN-wide tile of output channels; the reduction runs in chunks
// of CH = 64 input channels. Operands live in shared memory as the
// unswizzled core matrices of wgmma_sm90.cuh:
//   * A (the prologued input) K-major: 16 bytes = 8 channels of one row;
//   * B (W, N contiguous in device memory) MN-major: 16 bytes = 8 output
//     channels of one input channel, read with imm-trans 1 — W lands as
//     it lies, with no transposed element-wise stores.
// The per-row arithmetic (chunk order over K, the k16 steps inside a
// chunk, the wgmma width BN) depends on the channel counts alone, never
// on M or on WGS: a row's y is the same in a batch of 1 and of 32.
#pragma once

#include "fused_conv_common.cuh"
#include "wgmma_sm90.cuh"

namespace dl4j {
namespace fwd {

using bf16 = __nv_bfloat16;
namespace sm90 = dl4j::sm90;

constexpr int CH = 64;           // reduction chunk (input channels)
constexpr int WG_ROWS = 64;      // output rows per warpgroup
constexpr int STAGES = 4;        // W ring (1x1: x, add and W)
constexpr int LEAD = STAGES - 2; // stages in flight ahead of the product
constexpr int SMEM_MAX = 232448; // dynamic shared memory a block may use
constexpr int SMS = 132;         // streaming multiprocessors of an H100

// the prologue's scale/shift rounded to bf16, as pairs of channels 2j,
// 2j + 1, for every input channel (shared memory, [C/2] each)
struct AffinePairs {
  __nv_bfloat162* s;
  __nv_bfloat162* t;

  __device__ __forceinline__ void fill(const float* scale, const float* shift,
                                       int C) const {
    if (scale == nullptr) return;
    for (int j = threadIdx.x; j < C / 2; j += blockDim.x) {
      s[j] = __floats2bfloat162_rn(scale[2 * j], scale[2 * j + 1]);
      t[j] = __floats2bfloat162_rn(shift[2 * j], shift[2 * j + 1]);
    }
  }

  // u = relu?(x*s + t [+ add]) of 8 channels from pair p0 on, with the
  // plain version's rounding points: mul/add.rn.bf16x2 round each product
  // and sum once, as the f32 path's rnd(__fmul_rn) / rnd(__fadd_rn) do (a
  // product or sum of two bf16 values is exact in f32, or rounds to the
  // larger operand either way); the .rn forms keep nvcc from contracting
  // x*s + t into one fma, which would round once
  __device__ __forceinline__ uint4 apply(uint4 x, uint4 add, int p0,
                                         bool aff, bool has_add,
                                         bool relu) const {
    __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&x);
    const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&add);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      __nv_bfloat162 r = aff ? __hadd2_rn(__hmul2_rn(v[q], s[p0 + q]),
                                          t[p0 + q])
                             : v[q];
      if (has_add) r = __hadd2_rn(r, a[q]);
      // _nan: a NaN stays NaN, as in torch.relu and jnp.maximum
      if (relu) r = __hmax2_nan(r, __float2bfloat162_rn(0.0f));
      v[q] = r;
    }
    return x;
  }
};

// 16-byte unit o of a [CH x BN] W stage (rows k0.., columns n0.. of a
// row-major [*, N] matrix) as MN-major core matrices: unit o holds row
// (o / BN) * 8 + o % 8, columns ((o / 8) % (BN / 8)) * 8 ..; LBO (along
// the reduction) = 16 * BN bytes, SBO (along N) = 128 bytes
template <int BN>
__device__ __forceinline__ void load_w(bf16* ws, const bf16* w, int N,
                                       int k0, int n0) {
  for (int o = threadIdx.x; o < CH * BN / 8; o += blockDim.x) {
    const int kr = (o / BN) * 8 + o % 8, nc = ((o / 8) % (BN / 8)) * 8;
    sm90::cp_async16(ws + o * 8, w + (size_t)(k0 + kr) * N + n0 + nc, true);
  }
}

// one CH-deep chunk: acc[64 x BN] (+)= A[64 x CH] * W stage[CH x BN];
// A K-major with core matrices `a_lbo` bytes apart along K and 128
// (3x3) or 1024 (1x1) bytes apart along M. The first chunk overwrites
// the accumulators (scale_d 0) rather than adding to zeros: no other
// instruction then defines them while products are in flight, which
// would make ptxas serialize the products
template <int BN>
__device__ __forceinline__ void mma_chunk(float* acc, const bf16* a,
                                          uint32_t a_lbo, uint32_t a_sbo,
                                          const bf16* ws, bool first) {
  sm90::fence_acc<BN>(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int s = 0; s < CH / 16; ++s)
    sm90::wgmma_ss<BN, 0, 1>(
        acc, sm90::desc(a + s * a_lbo, a_lbo, a_sbo),   // 2 core matrices
        sm90::desc(ws + s * 16 * BN, 16 * BN, 128), !first || s > 0);
  sm90::wgmma_commit();
  sm90::fence_acc<BN>(acc);
}

// fixed-order sum over the 8 row groups g of a warp (lanes t, t+4, ...)
__device__ __forceinline__ float sum_over_g(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

// shared memory of the epilogue, laid over the operand buffers once the
// product is done: y rounded to bf16 ([WGS*64][BN + 8], the pitch keeps
// the fragment stores free of bank conflicts), and each warp's column
// sums and sums of squares ([2][4*WGS][BN] f32)
template <int WGS, int BN>
struct Epi {
  static constexpr int PITCH = BN + 8;
  static constexpr int Y = WGS * WG_ROWS * PITCH * 2;
  static constexpr int BYTES = Y + 2 * 4 * WGS * BN * 4;
};

// y = acc + bias rounded once to bf16, stored as 16-byte vectors through
// shared memory; with `partial`, the column sums and sums of squares of
// the ROUNDED y over the block's rows — each thread's two rows, then warp
// shuffles, then the warps in order — into row `tile` of the [2, tiles,
// N] partials. row_of(r) gives the y row of block row r (-1: none: a row
// past M, a 3x3 pad column); bias_s is the block's [BN] bias in shared
// memory. Every thread of the block calls this.
template <int WGS, int BN, typename RowOf>
__device__ __forceinline__ void epilogue(const float* acc, const RowOf& row_of,
                                         const float* bias_s, bf16* y, int N,
                                         int n0, float* partial, size_t tiles,
                                         int tile, unsigned char* smem) {
  using E = Epi<WGS, BN>;
  bf16* ys = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + E::Y);   // [2][warps][BN]
  constexpr int WARPS = 4 * WGS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * (warp / 4) + 16 * (warp % 4) + g;   // and r0 + 8
  const bool stats = partial != nullptr;
  const bool ok0 = stats && row_of(r0) >= 0, ok1 = stats && row_of(r0 + 8) >= 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t;
    float s[2] = {0.0f, 0.0f}, q[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          acc[4 * j + 2 * h] + bias_s[col], acc[4 * j + 2 * h + 1] + bias_s[col + 1]);
      *reinterpret_cast<__nv_bfloat162*>(ys + (r0 + 8 * h) * E::PITCH + col) = v;
      if (h ? ok1 : ok0) {
        const float f[2] = {__low2float(v), __high2float(v)};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[e] = __fadd_rn(s[e], f[e]);
          q[e] = __fadd_rn(q[e], __fmul_rn(f[e], f[e]));
        }
      }
    }
    if (stats) {   // uniform over the block
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float vs = sum_over_g(s[e]), vq = sum_over_g(q[e]);
        if (g == 0) {
          red[warp * BN + col + e] = vs;
          red[(WARPS + warp) * BN + col + e] = vq;
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < WGS * WG_ROWS * BN / 8; i += blockDim.x) {
    const int r = i / (BN / 8), v = i % (BN / 8);
    const int row = row_of(r);
    if (row >= 0)
      *reinterpret_cast<uint4*>(y + (size_t)row * N + n0 + v * 8) =
          *reinterpret_cast<const uint4*>(ys + r * E::PITCH + v * 8);
  }
  if (!stats) return;
  for (int c = tid; c < BN; c += blockDim.x) {
    float s = red[c], q = red[WARPS * BN + c];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      s = __fadd_rn(s, red[w * BN + c]);
      q = __fadd_rn(q, red[(WARPS + w) * BN + c]);
    }
    partial[(size_t)tile * N + n0 + c] = s;
    partial[(tiles + tile) * N + n0 + c] = q;
  }
}

// the block's bias tile in shared memory (0 without a bias)
template <int BN>
__device__ __forceinline__ void fill_bias(float* bias_s, const float* bias,
                                          int n0) {
  for (int c = threadIdx.x; c < BN; c += blockDim.x)
    bias_s[c] = bias != nullptr ? bias[n0 + c] : 0.0f;
}

// warpgroups per block: two (sharing each W stage) where the grid still
// launches `per_sm` blocks per SM, else one. The 1x1 asks for two; the
// 3x3, whose blocks each read the whole of W for their rows, for one:
// there the shared W stage wins over a second block per SM (28x28 at
// batch 32: 0.121 -> 0.077 ms per call)
inline int warpgroups(long long row_tiles64, int N, int bn, int per_sm) {
  return (row_tiles64 + 1) / 2 * (N / bn) >= per_sm * SMS ? 2 : 1;
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_MAX);
}

}  // namespace fwd
}  // namespace dl4j

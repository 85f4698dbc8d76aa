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
// Two routes, picked by the wrapper (pallas_conv.forward_route) from
// dtype, shape and alignment and checked again here:
//
// bf16 route "wgmma" (K, N multiples of 64, 16-byte aligned operands):
// what bounds it on an H100 SXM (3.35 TB/s, 989 TF/s bf16) is memory:
// ResNet-50's shapes have 2*K*N/(2*(K+N)) = 26..410 FLOP per byte, under
// the card's ridge (~295) but for the widest. The design keeps bytes in
// flight and reads x as few times as the tile allows:
//   * blocks of WGS warpgroups x 64 rows and a 128- (or 64-) wide tile of
//     N (128 where N allows), so x is re-read N/128 times, from L2, not
//     N/64: at the 7x7 and 14x14 stages those L2 re-reads, not the copy
//     latency, held the deep calls (a deeper ring did not help, 128-wide
//     tiles cut their time by 15-35%); WGS = 2 where the grid still fills
//     the card twice over (each W stage then serves 128 rows), else 1;
//   * K in 64-deep chunks through a ring of up to 4 shared-memory stages
//     filled by cp.async (x, add and W of chunk c+2 in flight while c is
//     multiplied; zero fill past M). cp.async and not TMA: every x tile
//     passes through the prologue by threads anyway, and the ragged edge
//     is a per-copy predicate;
//   * x and add land as wgmma's K-major core matrices; one in-place pass
//     turns them into u in bf16 pairs (mul/add.rn.bf16x2: the plain
//     version's bits) and, in the first N tile's blocks, writes u out
//     with 16-byte stores; then fence.proxy.async and wgmma m64nBNk16
//     reads u and W (MN-major, imm-trans 1: W lands as it lies) from
//     shared memory, overlapping the next chunk's transform;
//   * the epilogue adds the bias in f32, rounds once, stores y as 16-byte
//     vectors through shared memory and takes the statistics of the
//     rounded y in a fixed tree into per-row-tile partials.
// x is not kept resident across N tiles: a block owns one N tile, so the
// prologue runs N/BN times on each x element (from L2 after the first).
//
// What bounds it now (H100, PERF.md): the large-M calls (the 56x56 and
// 28x28 stages) run at 2-4.4x their bytes bound; the deep ones of the
// 14x14 and 7x7 stages at 4-16x, held by the re-reads of x (and add) from
// L2, N/128 per element, and by each block's chain of copy wait, barrier,
// prologue pass and product over few rows. Wider N tiles (two warpgroups
// side by side over one x tile) would halve those re-reads.
//
// f32 and every other shape or pointer: route "simple", the first design, in
// fused_conv_common.cuh (64x64 tiles, register prefetch of one chunk,
// mma.sync for bf16, FMA for f32: the f32 path must not use TF32).
#include "fused_conv_sm90.cuh"

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

// ------------------------------------------------ the bf16 (wgmma) route

namespace wg {

using bf16 = __nv_bfloat16;
namespace fwd = dl4j::fwd;
namespace sm90 = dl4j::sm90;
using fwd::CH;

struct Args {
  const bf16* x;
  const bf16* w;
  const float* bias;    // nullptr = no bias
  const float* scale;   // nullptr = no affine
  const float* shift;
  const bf16* add;      // nullptr = no residual term
  bf16* y;
  float* partial;       // nullptr = no statistics
  bf16* u;              // nullptr = do not emit u
  int M, K, N;
  bool relu;
};

// bytes of one warpgroup's [64 x CH] tile of x (or of add)
constexpr int XT = fwd::WG_ROWS * CH * 2;

// dynamic shared memory: the ring (stages of x, add, W; the epilogue's
// staging once the product is done), the affine pairs [K/2] x 2, the bias
template <int WGS, int BN>
struct Layout {
  int stage, stages, ring, bytes;
  __host__ __device__ Layout(int K, bool has_add) {
    stage = WGS * XT * (has_add ? 2 : 1) + CH * BN * 2;
    stages = K / CH < fwd::STAGES ? K / CH : fwd::STAGES;
    ring = stages * stage > fwd::Epi<WGS, BN>::BYTES ? stages * stage
                                                     : fwd::Epi<WGS, BN>::BYTES;
    bytes = ring + K * 4 + BN * 4;
  }
};

template <int WGS, int BN>
__global__ void __launch_bounds__(WGS * 128) conv1x1_wgmma_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bool has_add = a.add != nullptr, aff = a.scale != nullptr;
  const Layout<WGS, BN> L(a.K, has_add);
  const fwd::AffinePairs ap{
      reinterpret_cast<__nv_bfloat162*>(smem + L.ring),
      reinterpret_cast<__nv_bfloat162*>(smem + L.ring + a.K * 2)};
  float* bias_s = reinterpret_cast<float*>(smem + L.ring + a.K * 4);
  const int tid = threadIdx.x, wgi = tid / 128;
  const int m0 = blockIdx.x * WGS * fwd::WG_ROWS, n0 = blockIdx.y * BN;
  const int nch = a.K / CH;
  const bool emit = a.u != nullptr && blockIdx.y == 0;   // first N tile
  const bool transform = aff || has_add || a.relu;
  const int w_off = WGS * XT * (has_add ? 2 : 1);
  ap.fill(a.scale, a.shift, a.K);
  fwd::fill_bias<BN>(bias_s, a.bias, n0);

  auto stage = [&](int c) { return smem + (c % L.stages) * L.stage; };
  // x (add) unit o: block row (o / 64) * 8 + o % 8, chunk channels
  // ((o / 8) % 8) * 8..: wgmma's K-major core matrices, each warpgroup's
  // 64 rows in 512 consecutive units (LBO 128 bytes, SBO 1024)
  auto load = [&](int c) {
    if (c < nch) {
      unsigned char* st = stage(c);
      bf16* xs = reinterpret_cast<bf16*>(st);
      bf16* as = reinterpret_cast<bf16*>(st + WGS * XT);
      for (int o = tid; o < WGS * 512; o += blockDim.x) {
        const int r = (o / 64) * 8 + o % 8, kc = ((o / 8) % 8) * 8;
        const bool ok = m0 + r < a.M;
        const size_t e = (size_t)(ok ? m0 + r : 0) * a.K + c * CH + kc;
        sm90::cp_async16(xs + o * 8, a.x + e, ok);
        if (has_add) sm90::cp_async16(as + o * 8, a.add + e, ok);
      }
      fwd::load_w<BN>(reinterpret_cast<bf16*>(st + w_off), a.w, a.N, c * CH,
                      n0);
    }
    sm90::cp_async_commit();   // possibly empty: keeps the group count
  };
  // in place: x -> u; the first N tile's blocks write u out
  auto prologue = [&](int c) {
    unsigned char* st = stage(c);
    bf16* xs = reinterpret_cast<bf16*>(st);
    const bf16* as = reinterpret_cast<const bf16*>(st + WGS * XT);
    for (int o = tid; o < WGS * 512; o += blockDim.x) {
      const int r = (o / 64) * 8 + o % 8, kc = ((o / 8) % 8) * 8;
      uint4 v = *reinterpret_cast<const uint4*>(xs + o * 8);
      if (transform) {
        const uint4 av = has_add ? *reinterpret_cast<const uint4*>(as + o * 8)
                                 : make_uint4(0u, 0u, 0u, 0u);
        v = ap.apply(v, av, (c * CH + kc) / 2, aff, has_add, a.relu);
        *reinterpret_cast<uint4*>(xs + o * 8) = v;
      }
      if (emit && m0 + r < a.M)
        *reinterpret_cast<uint4*>(a.u + (size_t)(m0 + r) * a.K + c * CH +
                                  kc) = v;
    }
  };

  float acc[BN / 2];   // defined by the first product (mma_chunk)
  for (int c = 0; c < fwd::LEAD; ++c) load(c);
  for (int c = 0; c < nch; ++c) {
    sm90::cp_async_wait<fwd::LEAD - 1>();   // chunk c landed
    __syncthreads();   // ... for every thread; wgmma(c - 2) is done
    load(c + fwd::LEAD);   // into the stage of chunk c - 2
    if (transform || emit) prologue(c);
    sm90::fence_proxy_async();   // u and W visible to wgmma
    __syncthreads();
    const unsigned char* st = stage(c);
    fwd::mma_chunk<BN>(acc, reinterpret_cast<const bf16*>(st) + wgi * 512 * 8,
                       128, 1024, reinterpret_cast<const bf16*>(st + w_off),
                       c == 0);
    sm90::wgmma_wait<1>();   // chunk c - 1's product is done
  }
  sm90::wgmma_wait<0>();
  sm90::fence_acc<BN>(acc);
  sm90::cp_async_wait<0>();
  __syncthreads();   // the ring is free for the epilogue
  const int M = a.M;
  const auto row_of = [m0, M](int r) { return m0 + r < M ? m0 + r : -1; };
  fwd::epilogue<WGS, BN>(acc, row_of, bias_s, a.y, a.N, n0, a.partial,
                         gridDim.x, blockIdx.x, smem);
}

// the output channel tile: 128 wide where N allows it, so that x
// is re-read from L2 N/128 times (64-wide tiles for the deep reductions
// launched more blocks at batch 32 but lost more to those re-reads);
// keyed on N alone
inline int tile_n(int N) { return N % 128 == 0 ? 128 : 64; }

struct Plan {
  int wgs, bn;
};

// tile width from N alone; warpgroups per block from the grid
inline Plan plan(int M, int N) {
  const int bn = tile_n(N);
  return {fwd::warpgroups((M + fwd::WG_ROWS - 1) / fwd::WG_ROWS, N, bn, 2), bn};
}

inline int row_tiles(int M, int N) {
  const int rows = plan(M, N).wgs * fwd::WG_ROWS;
  return (M + rows - 1) / rows;
}

template <int WGS, int BN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const Layout<WGS, BN> L(a.K, a.add != nullptr);
  if (L.bytes > fwd::SMEM_MAX) return cudaErrorInvalidValue;
  const dim3 grid(row_tiles(a.M, a.N), a.N / BN);
  conv1x1_wgmma_kernel<WGS, BN><<<grid, WGS * 128, L.bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t run(const Args& a, cudaStream_t stream) {
  const void* ptrs[] = {a.x, a.w, a.add, a.y, a.u};
  for (const void* p : ptrs)
    if (!dl4j::aligned16(p)) return cudaErrorInvalidValue;
  if (a.M <= 0 || a.K % CH != 0 || a.N % 64 != 0) return cudaErrorInvalidValue;
  const Plan p = plan(a.M, a.N);
  if (p.wgs == 2)
    return p.bn == 128 ? launch<2, 128>(a, stream) : launch<2, 64>(a, stream);
  return p.bn == 128 ? launch<1, 128>(a, stream) : launch<1, 64>(a, stream);
}

}  // namespace wg

}  // namespace

extern "C" {
// rows of the [2, tiles, N] statistics partials on `route` (0 simple,
// 1 wgmma): the wrapper sizes the scratch with it
int dl4j_conv1x1_row_tiles(int route, int M, int N) {
  return route ? wg::row_tiles(M, N) : (M + dl4j::BM - 1) / dl4j::BM;
}

// once, when the library is loaded: the wgmma route's blocks may use
// more than 48 KB of dynamic shared memory
int dl4j_init() {
  namespace fwd = dl4j::fwd;
  cudaError_t e = fwd::allow_smem(wg::conv1x1_wgmma_kernel<1, 64>);
  if (e == cudaSuccess) e = fwd::allow_smem(wg::conv1x1_wgmma_kernel<1, 128>);
  if (e == cudaSuccess) e = fwd::allow_smem(wg::conv1x1_wgmma_kernel<2, 64>);
  if (e == cudaSuccess) e = fwd::allow_smem(wg::conv1x1_wgmma_kernel<2, 128>);
  return static_cast<int>(e);
}

int fused_conv1x1_launch(int is_bf16, const void* x, const void* w,
                         const void* b, const void* scale, const void* shift,
                         const void* add, void* y, void* partial, void* ssum,
                         void* ssq, void* u, int M, int K, int N, int relu,
                         int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (route != 0) {
    if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    using bf16 = __nv_bfloat16;
    const wg::Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                     static_cast<const float*>(b),
                     static_cast<const float*>(scale),
                     static_cast<const float*>(shift),
                     static_cast<const bf16*>(add), static_cast<bf16*>(y),
                     static_cast<float*>(partial), static_cast<bf16*>(u),
                     M, K, N, relu != 0};
    e = wg::run(a, st);
    if (e == cudaSuccess && partial != nullptr)
      e = dl4j::reduce_stats(static_cast<const float*>(partial),
                                  wg::row_tiles(M, N), N,
                                  static_cast<float*>(ssum),
                                  static_cast<float*>(ssq), st);
  } else {
    e = is_bf16 ? run<__nv_bfloat16>(x, w, b, scale, shift, add, y, partial,
                                     ssum, ssq, u, M, K, N, relu, st)
                : run<float>(x, w, b, scale, shift, add, y, partial, ssum,
                             ssq, u, M, K, N, relu, st);
  }
  return static_cast<int>(e);
}
}

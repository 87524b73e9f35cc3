// int8 x int8 -> int32 convolution with a fused per-out-channel epilogue, for
// sm_90a, on the shared Hopper mainloop (hopper_gemm.cuh).
//
// Replaces the Pallas TPU kernel yololp_tpu/ops/pallas_conv.py:_conv_kernel
// (3x3, stride 1, pad 1, the deploy RepBlock chain links) and, on the port's
// int8 path, every other calibrated conv that the JAX package leaves to XLA's
// int8 conv (quant/int8_infer.py:_int8_conv): 1x1, and 3x3 with stride 2.
//
// Function. x (N, H, W, C) int8 NHWC, w (O, KH, KW, C) int8 (one reduction
// vector of K = KH*KW*C per output channel), pad = KH/2, a and b (O,) float.
// acc = sum over (ky, kx, c) of x[n, oy*s-p+ky, ox*s-p+kx, c] *
// w[o, ky, kx, c], zero outside the map, exact in int32. Then, per mode:
//   0  int8:  clip(rint(acc*a + b), relu ? 0 : -128, 127)
//   1  fp32:  acc*a + b, relu optional
//   2  bf16:  the same, rounded to bf16
//   3  int32: acc itself (no epilogue; for tests of the accumulator)
// rint rounds half to even (as jnp.round and torch.round do); the multiply and
// the add are two rounded operations (__fmul_rn, __fadd_rn, and the file is
// built with -fmad=false), so the result equals the plain PyTorch version
// (ops/cuda_conv.py:int8_conv_plain) bit for bit.
//
// Design: an implicit GEMM, M = N*Ho*Wo output pixels by O output channels
// over K, in 128 x BN tiles (BN = 16, 64 or 128 by O) walked by a
// persistent grid (one block per SM). The weights, (O, K)
// K-major and static, arrive by TMA through a tensor map the wrapper builds
// once per weight tensor (int8_conv_weight_map). The im2col rows of A are
// gathered by two producer warpgroups: thread t owns the 16-byte chunk t % 8
// of rows t / 8 + 32 i (i < 4), whose image and input corner it computes once
// per tile; the (tap, channel) position of its chunk advances by 128 bytes
// a stage with no division. With C % 16 == 0 a chunk lies in one tap and is
// one cp.async (zero-filled at the borders and past K) into the 128B-swizzled
// slot, and each thread signals the stage's full barrier with
// cp.async.mbarrier.arrive.noinc. Otherwise (no conv of the int8 path) the
// chunk is gathered byte by byte and stored. Two consumer warpgroups run
// wgmma m64nBNk32 s8 from the ring; the epilogue applies acc*a+b with the
// tile's a and b staged once in shared memory and stores through shared
// memory (TMA where whole 128-byte panels fit).
//
// What bounds it on an H100: a chain link at 80x80, C = O = 128, batch 32 is
// 3.0e10 MACs (0.030 ms of the 1979 TOP/s int8 peak) over 52 MB in and out
// (0.016 ms at 3.35 TB/s): operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using hg::kBM;
using hg::kKB;

// two producer warpgroups gather A (one gathers too slowly to keep the
// tensor cores fed), then the two consumer warpgroups
constexpr int kProducers = 256;
constexpr int kThreads = kProducers + hg::kConsumers;
constexpr int kRowStep = kProducers / 8;  // a producer thread's rows: r0 + kRowStep i
constexpr int kRowsPer = kBM / kRowStep;

struct Geom {
  int N, H, W, C, O, KH, KW, stride, pad, Ho, Wo, M, K;
};

template <int kMode>
struct OutOf;
template <>
struct OutOf<0> {
  using T = int8_t;
};
template <>
struct OutOf<1> {
  using T = float;
};
template <>
struct OutOf<2> {
  using T = __nv_bfloat16;
};
template <>
struct OutOf<3> {
  using T = int;
};

// the position of a chunk in the reduction: channel c of tap (ky, kx)
struct Tap {
  int c, ky, kx;
  __device__ __forceinline__ void advance(int bytes, const Geom& g) {
    c += bytes;
    while (c >= g.C) {
      c -= g.C;
      if (++kx == g.KW) {
        kx = 0;
        ++ky;
      }
    }
  }
};

template <int BN, int kMode, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    int8_conv_kernel(const int8_t* __restrict__ x, const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap, const float* __restrict__ a,
                     const float* __restrict__ b, void* __restrict__ out, Geom g, int stages,
                     int use_tma, int relu) {
  using Out = typename OutOf<kMode>::T;
  extern __shared__ uint8_t smem_raw[];
  const hg::Ring r = hg::carve(smem_raw, BN, sizeof(Out), stages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hg::mbar_init(&r.full[s], kProducers + 1);  // the producers' copies, the weights' expect_tx
      hg::mbar_init(&r.empty[s], 2);       // one arrival per consumer warpgroup
    }
    hg::fence_barrier_init();
  }
  __syncthreads();

  const int NT = (g.O + BN - 1) / BN;
  const int tiles = (g.M + kBM - 1) / kBM * NT;
  const int KT = (g.K + kKB - 1) / kKB;
  if (threadIdx.x < kProducers) {
    const int t = threadIdx.x;
    const int j = t & 7, r0 = t >> 3;
    // the swizzled slot of chunk j in rows r0 + kRowStep i: their row % 8 is r0 % 8
    const int slot = r0 * kKB + ((j ^ (r0 & 7)) << 4);
    const int hw = g.Ho * g.Wo;
    hg::ProducerRing p;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / NT * kBM, n0 = tile % NT * BN;
      // this thread's rows: image base and input corner (rows past M read
      // as outside the map)
      const int8_t* img[kRowsPer];
      int iy0[kRowsPer], ix0[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const int m = m0 + r0 + kRowStep * i;
        const int mm = m < g.M ? m : 0;
        const int n = mm / hw;
        const int rem = mm - n * hw;
        const int oy = rem / g.Wo;
        const int ox = rem - oy * g.Wo;
        img[i] = x + (long long)n * g.H * g.W * g.C;
        iy0[i] = m < g.M ? oy * g.stride - g.pad : -(1 << 28);
        ix0[i] = ox * g.stride - g.pad;
      }
      Tap tap{0, 0, 0};
      tap.advance(16 * j, g);
      for (int kt = 0; kt < KT; ++kt, p.next(stages)) {
        p.wait_empty(r);
        if (t == 0) {
          hg::mbar_arrive_expect_tx(&r.full[p.s], BN * kKB);
          hg::tma_load_2d(hg::smem_u32(r.b + p.s * BN * kKB), &wmap, &r.full[p.s], kt * kKB, n0);
        }
        uint8_t* stage = r.a + p.s * kBM * kKB + slot;
        if (kVec) {
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) {
            const int iy = iy0[i] + tap.ky, ix = ix0[i] + tap.kx;
            const bool in = tap.ky < g.KH && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
            const int8_t* src = in ? img[i] + ((long long)iy * g.W + ix) * g.C + tap.c : x;
            hg::cp_async16(hg::smem_u32(stage + i * kRowStep * kKB), src, in);
          }
          hg::cp_async_arrive_noinc(&r.full[p.s]);
        } else {
#pragma unroll 1
          for (int i = 0; i < kRowsPer; ++i) {
            uint32_t w4[4] = {0, 0, 0, 0};
            Tap q = tap;
            for (int e = 0; e < 16; ++e) {
              const int iy = iy0[i] + q.ky, ix = ix0[i] + q.kx;
              if (q.ky < g.KH && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
                w4[e >> 2] |= (uint32_t)(uint8_t)img[i][((long long)iy * g.W + ix) * g.C + q.c]
                              << (8 * (e & 3));
              q.advance(1, g);
            }
            *reinterpret_cast<uint4*>(stage + i * kRowStep * kKB) =
                make_uint4(w4[0], w4[1], w4[2], w4[3]);
          }
          hg::fence_proxy_async();
          hg::mbar_arrive(&r.full[p.s]);
        }
        tap.advance(kKB, g);
      }
    }
  } else {
    const int cw = (threadIdx.x - kProducers) / 128;
    const int t = threadIdx.x & 127;
    float* sa = r.ab + cw * 256;
    float* sb = sa + 128;
    const float lo = relu ? 0.f : -128.f;
    int s = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / NT * kBM, n0 = tile % NT * BN;
      // the tile's epilogue constants, once (read after store_tile's first
      // barrier; the last tile's readers are past its second)
      if (kMode != 3) {
        for (int i = t; i < BN; i += 128) {
          const int o = n0 + i;
          sa[i] = o < g.O ? a[o] : 0.f;
          sb[i] = o < g.O ? b[o] : 0.f;
        }
      }
      int acc[BN / 2];
      hg::consume<hg::S8, BN, false, true>(acc, r, stages, KT, cw, s, phase);
      auto epi = [&](int v32, int col) -> Out {
        if constexpr (kMode == 3) {
          return v32;
        } else {
          float v = __fadd_rn(__fmul_rn(__int2float_rn(v32), sa[col]), sb[col]);
          if constexpr (kMode == 0) {
            v = fminf(fmaxf(rintf(v), lo), 127.f);
            return (int8_t)__float2int_rn(v);
          } else {
            if (relu) v = fmaxf(v, 0.f);
            if constexpr (kMode == 1)
              return v;
            else
              return __float2bfloat16_rn(v);
          }
        }
      };
      hg::store_tile<BN>(acc, epi, r, cw, &omap, use_tma != 0, static_cast<Out*>(out), g.O, g.M,
                         g.O, m0 + 64 * cw, n0);
    }
    hg::store_drain();
  }
}

constexpr CUtensorMapDataType kOutType[4] = {
    CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
    CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_DATA_TYPE_INT32};

template <int BN, int kMode, bool kVec>
int launch(const int8_t* x, const CUtensorMap& wmap, const float* a, const float* b, void* out,
           const Geom& g, int relu, cudaStream_t stream) {
  using Out = typename OutOf<kMode>::T;
  CUtensorMap omap;
  bool use_tma = false;
  int err = hg::output_map(&omap, &use_tma, kOutType[kMode], sizeof(Out), out, g.M, g.O, BN);
  if (err) return err;
  const int stages = hg::plan_stages(BN, sizeof(Out));
  const int smem = hg::smem_bytes(BN, sizeof(Out), stages);
  int blocks = 0;
  err = hg::prepare<int8_conv_kernel<BN, kMode, kVec>>(
      kThreads, smem, (long long)((g.M + kBM - 1) / kBM) * ((g.O + BN - 1) / BN), &blocks);
  if (err) return err;
  int8_conv_kernel<BN, kMode, kVec><<<blocks, kThreads, smem, stream>>>(
      x, wmap, omap, a, b, out, g, stages, (int)use_tma, relu);
  return (int)cudaGetLastError();
}

template <int BN, bool kVec>
int launch_mode(int mode, const int8_t* x, const CUtensorMap& wmap, const float* a,
                const float* b, void* out, const Geom& g, int relu, cudaStream_t stream) {
  switch (mode) {
    case 0: return launch<BN, 0, kVec>(x, wmap, a, b, out, g, relu, stream);
    case 1: return launch<BN, 1, kVec>(x, wmap, a, b, out, g, relu, stream);
    case 2: return launch<BN, 2, kVec>(x, wmap, a, b, out, g, relu, stream);
    default: return launch<BN, 3, kVec>(x, wmap, a, b, out, g, relu, stream);
  }
}

template <bool kVec>
int launch_bn(int mode, const int8_t* x, const CUtensorMap& wmap, const float* a, const float* b,
              void* out, const Geom& g, int relu, cudaStream_t stream) {
  switch (hg::tile_n(g.O)) {
    case 16: return launch_mode<16, kVec>(mode, x, wmap, a, b, out, g, relu, stream);
    case 64: return launch_mode<64, kVec>(mode, x, wmap, a, b, out, g, relu, stream);
    default: return launch_mode<128, kVec>(mode, x, wmap, a, b, out, g, relu, stream);
  }
}

}  // namespace

// The TMA map of the weights: w (O, K) int8, rows ldw bytes apart (ldw and
// w's address multiples of 16), K = KH*KW*C; boxes of 128 bytes of K by the
// tile width int8_conv_launch takes for O. Written to map_out (128 bytes),
// which int8_conv_launch then takes; build it once per weight tensor.
// Returns 0 or an error code as int8_conv_launch does.
extern "C" int int8_conv_weight_map(const int8_t* w, int O, long long K, long long ldw,
                                    void* map_out) {
  if (O <= 0 || K <= 0 || ldw < K || ldw % 16 || (reinterpret_cast<uintptr_t>(w) & 15))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = hg::encode_2d(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, O, ldw, kKB,
                                hg::tile_n(O), CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) memcpy(map_out, &map, sizeof(map));
  return err;
}

// x (N, H, W, C) int8 contiguous, wmap from int8_conv_weight_map for the
// (O, KH*KW*C) weights, a and b (O,) f32 (unused in mode 3), out
// (N, Ho, Wo, O) of the mode's type, contiguous; all on card `device`.
// KH = KW in {1, 3}, stride in {1, 2}, pad = KH / 2. Launches on `stream`,
// allocates nothing, returns 0, a cudaError_t, or one of hopper_gemm.cuh's
// tensor-map codes. The library links its own CUDA runtime, hence `device`.
extern "C" int int8_conv_launch(const int8_t* x, const void* wmap, const float* a,
                                const float* b, void* out, int N, int H, int W, int C, int O,
                                int KH, int stride, int mode, int relu, int device,
                                cudaStream_t stream) {
  if ((KH != 1 && KH != 3) || (stride != 1 && stride != 2) || mode < 0 || mode > 3 || N <= 0 ||
      H <= 0 || W <= 0 || C <= 0 || O <= 0)
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.N = N; g.H = H; g.W = W; g.C = C; g.O = O;
  g.KH = KH; g.KW = KH; g.stride = stride; g.pad = KH / 2;
  g.Ho = (H + 2 * g.pad - KH) / stride + 1;
  g.Wo = (W + 2 * g.pad - KH) / stride + 1;
  const long long M = (long long)N * g.Ho * g.Wo;
  const long long K = (long long)KH * KH * C;
  if (M >= (1LL << 31) - kBM || K >= (1LL << 30) || (long long)N * H * W >= (1LL << 31) ||
      (M + kBM - 1) / kBM * ((O + 15) / 16) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  g.M = (int)M;
  g.K = (int)K;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map;
  memcpy(&map, wmap, sizeof(map));
  const bool vec = C % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (vec) return launch_bn<true>(mode, x, map, a, b, out, g, relu, stream);
  return launch_bn<false>(mode, x, map, a, b, out, g, relu, stream);
}

// The plan of a launch with O output channels in `mode`: {tile rows, tile
// columns, stages, dynamic shared memory bytes}.
extern "C" void int8_conv_plan(int O, int mode, int* plan) {
  static const int kEs[4] = {1, 4, 2, 4};
  const int bn = hg::tile_n(O);
  const int es = kEs[mode & 3];
  const int stages = hg::plan_stages(bn, es);
  plan[0] = kBM;
  plan[1] = bn;
  plan[2] = stages;
  plan[3] = hg::smem_bytes(bn, es, stages);
}

// int8 x int8 -> int32 convolution with a fused per-out-channel epilogue, for
// sm_90a.
//
// Replaces the Pallas TPU kernel yololp_tpu/ops/pallas_conv.py:_conv_kernel
// (3x3, stride 1, pad 1, the deploy RepBlock chain links) and, on the port's
// int8 path, every other calibrated conv that the JAX package leaves to XLA's
// int8 conv (quant/int8_infer.py:_int8_conv): 1x1, and 3x3 with stride 2.
//
// Function. x (N, H, W, C) int8 NHWC, w (O, KH, KW, C) int8 (one contiguous
// reduction vector of K = KH*KW*C per output channel), pad = KH/2, a and b
// (O,) float. acc = sum over (ky, kx, c) of x[n, oy*s-p+ky, ox*s-p+kx, c] *
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
// over K. A block computes a 128 x 64 tile with 8 warps (4 along M, 2 along
// O), each warp 32 x 32 as 2 x 4 mma.sync.m16n8k32.s8 tiles, the int32
// accumulator in registers. The K loop takes 64 bytes a step: the input
// tile (the im2col rows, gathered on the fly with the stride, and zero at
// the borders) and the weight tile go to shared memory through cp.async,
// two stages deep, rows padded to 80 bytes so fragment loads hit 32
// distinct banks. The epilogue is applied to the accumulator in registers
// and only the result is written. When C % 16 == 0 each 16-byte piece of a
// row lies in one tap and is copied whole; otherwise bytes are gathered one
// by one (correct for any C, slow).
//
// What bounds it on an H100: a chain link at 80x80, C = O = 128, batch 32 is
// 3.0e10 MACs (0.030 ms of the 1979 TOP/s int8 peak) over 52 MB in and out
// (0.016 ms at 3.35 TB/s): operations. This first version uses mma.sync, not
// wgmma, and a synchronous two-stage copy, so it runs well below that peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;   // output pixels per block
constexpr int kBN = 64;    // output channels per block
constexpr int kBK = 64;    // reduction bytes per stage
constexpr int kLds = 80;   // padded shared row stride in bytes
constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n"); }

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

struct Geom {
  int N, H, W, C, O, KH, KW, stride, pad, Ho, Wo, M, K;
};

// One output pixel row of the A tile: its image and the input corner.
struct RowInfo {
  const int8_t* img;
  int iy0, ix0;
  bool valid;
};

__device__ __forceinline__ RowInfo row_info(const int8_t* x, const Geom& g, int m) {
  RowInfo r;
  r.valid = m < g.M;
  const int mm = r.valid ? m : 0;
  const int hw = g.Ho * g.Wo;
  const int n = mm / hw;
  const int rem = mm - n * hw;
  const int oy = rem / g.Wo;
  const int ox = rem - oy * g.Wo;
  r.img = x + (size_t)n * g.H * g.W * g.C;
  r.iy0 = oy * g.stride - g.pad;
  r.ix0 = ox * g.stride - g.pad;
  return r;
}

__device__ __forceinline__ int8_t gather(const RowInfo& r, const Geom& g, int k) {
  if (!r.valid || k >= g.K) return 0;
  const int tap = k / g.C;
  const int c = k - tap * g.C;
  const int ky = tap / g.KW;
  const int kx = tap - ky * g.KW;
  const int iy = r.iy0 + ky, ix = r.ix0 + kx;
  if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) return 0;
  return r.img[((size_t)iy * g.W + ix) * g.C + c];
}

template <bool kVec>
__device__ __forceinline__ void load_stage(int8_t* As, int8_t* Bs, const int8_t* x,
                                           const int8_t* w, const Geom& g,
                                           const RowInfo* rows, int n0, int kt) {
  const int tid = threadIdx.x;
  // A: 128 rows x 4 pieces of 16 bytes, two pieces a thread
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = tid + j * kThreads;
    const int r = q >> 2;
    const int k0 = kt * kBK + (q & 3) * 16;
    int8_t* dst = As + r * kLds + (q & 3) * 16;
    const RowInfo& ri = rows[j];
    if (kVec) {
      const int8_t* src = x;
      bool pred = ri.valid && k0 < g.K;
      if (pred) {
        const int tap = k0 / g.C;
        const int c = k0 - tap * g.C;
        const int ky = tap / g.KW;
        const int kx = tap - ky * g.KW;
        const int iy = ri.iy0 + ky, ix = ri.ix0 + kx;
        pred = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
        if (pred) src = ri.img + ((size_t)iy * g.W + ix) * g.C + c;
      }
      cp_async16(dst, src, pred);
    } else {
#pragma unroll 4
      for (int e = 0; e < 16; ++e) dst[e] = gather(ri, g, k0 + e);
    }
  }
  // B: 64 rows x 4 pieces, one piece a thread
  {
    const int r = tid >> 2;
    const int k0 = kt * kBK + (tid & 3) * 16;
    const int o = n0 + r;
    int8_t* dst = Bs + r * kLds + (tid & 3) * 16;
    if (kVec) {
      const bool pred = o < g.O && k0 < g.K;
      cp_async16(dst, pred ? w + (size_t)o * g.K + k0 : w, pred);
    } else {
#pragma unroll 4
      for (int e = 0; e < 16; ++e) {
        const int k = k0 + e;
        dst[e] = (o < g.O && k < g.K) ? w[(size_t)o * g.K + k] : (int8_t)0;
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ a, const float* __restrict__ b,
                     void* __restrict__ out, Geom g, int mode, int relu) {
  __shared__ __align__(16) int8_t As[2][kBM * kLds];
  __shared__ __align__(16) int8_t Bs[2][kBN * kLds];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;
  const int warp_n = warp >> 2;
  const int gid = lane >> 2;  // groupID of the mma fragment layouts
  const int tig = lane & 3;   // thread in group
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  RowInfo rows[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) rows[j] = row_info(x, g, m0 + ((tid + j * kThreads) >> 2));

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int KT = (g.K + kBK - 1) / kBK;
  load_stage<kVec>(As[0], Bs[0], x, w, g, rows, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < KT) load_stage<kVec>(As[st ^ 1], Bs[st ^ 1], x, w, g, rows, n0, kt + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int8_t* as = As[st];
    const int8_t* bs = Bs[st];
#pragma unroll
    for (int s = 0; s < kBK / 32; ++s) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = as + (warp_m * 32 + mi * 16 + gid) * kLds + s * 32 + tig * 4;
        af[mi][0] = lds32(p);
        af[mi][1] = lds32(p + 8 * kLds);
        af[mi][2] = lds32(p + 16);
        af[mi][3] = lds32(p + 8 * kLds + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = bs + (warp_n * 32 + ni * 8 + gid) * kLds + s * 32 + tig * 4;
        bf[ni][0] = lds32(p);
        bf[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi][0], af[mi][1], af[mi][2], af[mi][3], bf[ni][0],
                 bf[ni][1]);
    }
    __syncthreads();
  }

  // epilogue: accumulator element r of tile (mi, ni) is at row gid (+8 for
  // r >= 2) and column 2*tig + (r & 1) of the 16 x 8 tile
  const float lo = relu ? 0.f : -128.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + warp_m * 32 + mi * 16 + gid + (r >= 2 ? 8 : 0);
        const int o = n0 + warp_n * 32 + ni * 8 + tig * 2 + (r & 1);
        if (m >= g.M || o >= g.O) continue;
        const size_t idx = (size_t)m * g.O + o;
        const int v32 = acc[mi][ni][r];
        if (mode == 3) {
          static_cast<int*>(out)[idx] = v32;
          continue;
        }
        float v = __fadd_rn(__fmul_rn(__int2float_rn(v32), a[o]), b[o]);
        if (mode == 0) {
          v = fminf(fmaxf(rintf(v), lo), 127.f);
          static_cast<int8_t*>(out)[idx] = (int8_t)__float2int_rn(v);
        } else {
          if (relu) v = fmaxf(v, 0.f);
          if (mode == 1)
            static_cast<float*>(out)[idx] = v;
          else
            static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

}  // namespace

// x (N, H, W, C) int8, w (O, KH, KW, C) int8, a and b (O,) f32 (unused in
// mode 3), out (N, Ho, Wo, O) of the mode's type; all contiguous on card
// `device`. KH = KW in {1, 3}, stride in {1, 2}, pad = KH / 2. Launches on
// `stream`, allocates nothing, returns the cudaError_t of the launch (0 on
// success). The library links its own CUDA runtime, hence `device`.
extern "C" int int8_conv_launch(const int8_t* x, const int8_t* w, const float* a,
                                const float* b, void* out, int N, int H, int W, int C,
                                int O, int KH, int stride, int mode, int relu, int device,
                                cudaStream_t stream) {
  if ((KH != 1 && KH != 3) || (stride != 1 && stride != 2) || mode < 0 || mode > 3 ||
      N <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0)
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.N = N; g.H = H; g.W = W; g.C = C; g.O = O;
  g.KH = KH; g.KW = KH; g.stride = stride; g.pad = KH / 2;
  g.Ho = (H + 2 * g.pad - KH) / stride + 1;
  g.Wo = (W + 2 * g.pad - KH) / stride + 1;
  const long long M = (long long)N * g.Ho * g.Wo;
  const long long K = (long long)KH * KH * C;
  if (M >= (1LL << 31) || K >= (1LL << 31) || M * O >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  g.M = (int)M;
  g.K = (int)K;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((O + kBN - 1) / kBN));
  const bool vec = C % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  if (vec)
    int8_conv_kernel<true><<<grid, kThreads, 0, stream>>>(x, w, a, b, out, g, mode, relu);
  else
    int8_conv_kernel<false><<<grid, kThreads, 0, stream>>>(x, w, a, b, out, g, mode, relu);
  return (int)cudaGetLastError();
}

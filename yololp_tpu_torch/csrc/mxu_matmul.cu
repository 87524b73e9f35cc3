// (M, K) @ (K, N) on the tensor cores, for sm_90a: bf16 x bf16 -> fp32 and
// int8 x int8 -> int32.
//
// Replaces the Pallas TPU kernel tools/probe_mxu_int8.py:_mm_kernel
// (pallas_matmul: a tiled matmul with full-K blocks and B resident, the
// probe of the matrix unit's bf16 and int8 rates). In the port it also runs
// the `dots` lowering of the int8 convs (quant/int8_infer.py:conv3x3_as_dots
// and the 1x1 convs), where K = C and N = O of every int8 conv of the model.
//
// Function. a (M, K) and b (K, N), row-major and contiguous, one type;
// out (M, N) row-major, fp32 for bf16 inputs and int32 for int8 inputs.
// Any M, N, K: the ragged edges are zero-filled in shared memory and the
// stores are bounds-checked. Offsets are 64-bit (M * K reaches 1e8 and more
// on the conv taps).
//
// Design: a block computes a 128 x BN tile (BN = 64 when N <= 64, else 128)
// with 8 warps (4 along M, 2 along N), each warp 32 x BN/2 as 2 x BN/16
// mma.sync tiles: m16n8k32.s8 with an s32 accumulator, or m16n8k16.bf16
// with an fp32 accumulator. Both take 32 bytes of K a step and have the same
// fragment layout in bytes, so one kernel body serves both types. The K loop
// takes 64 bytes a stage, two stages deep. A goes to shared memory through
// cp.async (byte copies when a row is not a multiple of 16 bytes). mma.sync
// wants B as "col" fragments, K contiguous for each n; B arrives row-major
// (K, N), so each thread loads a 4-row x 4-byte block of it into registers
// (the next stage's, while the current one computes), transposes it there
// (bytes for int8, 16-bit halves for bf16; ldmatrix.trans moves only 16-bit
// elements) and stores it as [n][k] rows. Shared rows are padded to 80 bytes
// so fragment loads hit 32 distinct banks.
//
// What bounds it on an H100: at the probe's shapes, (16384, 512) @ (512, 512)
// in bf16 moves 17.3 MB in and 33.6 MB out against 8.6 GFLOP: bytes (15.2 us
// at 3.35 TB/s); (4096, 2048) @ (2048, 2048) is 34.4 GFLOP: operations
// (34.7 us of the 989 TFLOP/s bf16 peak, 17.4 us of the 1979 TOP/s int8
// peak). The fp32 / int32 output is most of the bytes. This first
// version uses mma.sync, not wgmma, and a two-stage synchronous pipeline, so
// it runs well below the tensor-core peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;     // rows of A per block
constexpr int kBKB = 64;     // reduction bytes per stage
constexpr int kLds = 80;     // padded shared row stride in bytes
constexpr int kThreads = 256;

struct S8 {
  using Acc = int;
  static constexpr int kEs = 1;
};

struct Bf16 {
  using Acc = float;
  static constexpr int kEs = 2;
};

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

__device__ __forceinline__ void mma(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A stage: 128 rows x 64 bytes, two 16-byte pieces a thread.
template <bool kVecA>
__device__ __forceinline__ void load_a(int8_t* As, const int8_t* a, int M, int Kb, int m0,
                                       int kt) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int r = q >> 2;
    const int kb = kt * kBKB + (q & 3) * 16;
    const int m = m0 + r;
    int8_t* dst = As + r * kLds + (q & 3) * 16;
    if (kVecA) {
      const bool pred = m < M && kb < Kb;
      cp_async16(dst, pred ? a + (size_t)m * Kb + kb : a, pred);
    } else {
      const int8_t* row = a + (size_t)(m < M ? m : 0) * Kb;
#pragma unroll 4
      for (int e = 0; e < 16; ++e) dst[e] = (m < M && kb + e < Kb) ? row[kb + e] : (int8_t)0;
    }
  }
}

// B stage: kBKB / kEs rows of K by kBN columns of N, in blocks of 4 rows x 4
// bytes, kBN / 64 blocks a thread; neighbouring threads take neighbouring
// column words of a row (coalesced loads).
template <class T, int kBN>
struct BBlocks {
  static constexpr int kPerThread = kBN / 64;
  static constexpr int kColWords = kBN * T::kEs / 4;
  uint32_t r[kPerThread][4];
};

template <class T, int kBN>
__device__ __forceinline__ void load_b(BBlocks<T, kBN>& blk, const int8_t* b, int K, int Nb,
                                       int n0b, int kt, bool vecB) {
  constexpr int kRows = kBKB / T::kEs;
#pragma unroll
  for (int j = 0; j < BBlocks<T, kBN>::kPerThread; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int kg = q / BBlocks<T, kBN>::kColWords;
    const int cw = q % BBlocks<T, kBN>::kColWords;
    const int k = kt * kRows + kg * 4;
    const int cb = n0b + cw * 4;
    if (vecB && k + 3 < K && cb + 3 < Nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        blk.r[j][i] = *reinterpret_cast<const uint32_t*>(b + (size_t)(k + i) * Nb + cb);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t w = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + i < K && cb + e < Nb)
            w |= (uint32_t)(uint8_t)b[(size_t)(k + i) * Nb + cb + e] << (8 * e);
        blk.r[j][i] = w;
      }
    }
  }
}

// The loaded blocks, transposed, into Bs[n][k] (rows of kLds bytes).
template <class T, int kBN>
__device__ __forceinline__ void store_b(int8_t* Bs, const BBlocks<T, kBN>& blk) {
#pragma unroll
  for (int j = 0; j < BBlocks<T, kBN>::kPerThread; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int kg = q / BBlocks<T, kBN>::kColWords;
    const int cw = q % BBlocks<T, kBN>::kColWords;
    const uint32_t* r = blk.r[j];
    if constexpr (T::kEs == 1) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = 8 * c;
        const uint32_t w = ((r[0] >> s) & 0xffu) | (((r[1] >> s) & 0xffu) << 8) |
                           (((r[2] >> s) & 0xffu) << 16) | (((r[3] >> s) & 0xffu) << 24);
        *reinterpret_cast<uint32_t*>(Bs + (cw * 4 + c) * kLds + kg * 4) = w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int s = 16 * c;
        const uint32_t lo = ((r[0] >> s) & 0xffffu) | (((r[1] >> s) & 0xffffu) << 16);
        const uint32_t hi = ((r[2] >> s) & 0xffffu) | (((r[3] >> s) & 0xffffu) << 16);
        *reinterpret_cast<uint2*>(Bs + (cw * 2 + c) * kLds + kg * 8) = make_uint2(lo, hi);
      }
    }
  }
}

template <class T, int kBN, bool kVecA>
__global__ void __launch_bounds__(kThreads)
    mxu_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                      typename T::Acc* __restrict__ out, int M, int N, int K, int vecB) {
  using Acc = typename T::Acc;
  constexpr int kNI = kBN / 16;  // 8-column mma tiles per warp
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
  const int Kb = K * T::kEs;
  const int Nb = N * T::kEs;

  Acc acc[2][kNI][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  BBlocks<T, kBN> blk;
  const int KT = (Kb + kBKB - 1) / kBKB;
  load_a<kVecA>(As[0], a, M, Kb, m0, 0);
  cp_async_commit();
  load_b<T, kBN>(blk, b, K, Nb, n0 * T::kEs, 0, vecB);
  store_b<T, kBN>(Bs[0], blk);
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < KT) {
      load_a<kVecA>(As[st ^ 1], a, M, Kb, m0, kt + 1);
      load_b<T, kBN>(blk, b, K, Nb, n0 * T::kEs, kt + 1, vecB);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int8_t* as = As[st];
    const int8_t* bs = Bs[st];
#pragma unroll
    for (int s = 0; s < kBKB / 32; ++s) {
      uint32_t af[2][4], bf[kNI][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = as + (warp_m * 32 + mi * 16 + gid) * kLds + s * 32 + tig * 4;
        af[mi][0] = lds32(p);
        af[mi][1] = lds32(p + 8 * kLds);
        af[mi][2] = lds32(p + 16);
        af[mi][3] = lds32(p + 8 * kLds + 16);
      }
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int8_t* p = bs + (warp_n * (kBN / 2) + ni * 8 + gid) * kLds + s * 32 + tig * 4;
        bf[ni][0] = lds32(p);
        bf[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) mma(acc[mi][ni], af[mi], bf[ni]);
    }
    if (kt + 1 < KT) store_b<T, kBN>(Bs[st ^ 1], blk);
    __syncthreads();
  }

  // accumulator element r of tile (mi, ni) is at row gid (+8 for r >= 2)
  // and column 2*tig + (r & 1) of the 16 x 8 tile; the two columns of a row
  // are stored as one 8-byte pair where both lie inside and N is even
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + warp_m * 32 + mi * 16 + gid + 8 * h;
        const int n = n0 + warp_n * (kBN / 2) + ni * 8 + tig * 2;
        if (m >= M) continue;
        Acc* dst = out + (size_t)m * N + n;
        const Acc v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (pairs && n + 1 < N) {
          if constexpr (T::kEs == 1)
            *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
          else
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (n < N) dst[0] = v0;
          if (n + 1 < N) dst[1] = v1;
        }
      }
    }
  }
}

template <class T, int kBN>
void launch(const void* a, const void* b, void* out, int M, int N, int K, bool vecA, bool vecB,
            cudaStream_t stream) {
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((N + kBN - 1) / kBN));
  using Acc = typename T::Acc;
  const int8_t* pa = static_cast<const int8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b);
  if (vecA)
    mxu_matmul_kernel<T, kBN, true><<<grid, kThreads, 0, stream>>>(
        pa, pb, static_cast<Acc*>(out), M, N, K, (int)vecB);
  else
    mxu_matmul_kernel<T, kBN, false><<<grid, kThreads, 0, stream>>>(
        pa, pb, static_cast<Acc*>(out), M, N, K, (int)vecB);
}

}  // namespace

// a (M, K) and b (K, N) row-major contiguous on card `device`; mode 0: int8
// inputs, out int32; mode 1: bf16 inputs, out fp32; out (M, N) row-major.
// Launches on `stream`, allocates nothing, returns the cudaError_t of the
// launch (0 on success). The library links its own CUDA runtime, hence
// `device`.
extern "C" int mxu_matmul_launch(const void* a, const void* b, void* out, long long M,
                                 long long N, long long K, int mode, int device,
                                 cudaStream_t stream) {
  if ((mode != 0 && mode != 1) || M <= 0 || N <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  const long long es = mode == 0 ? 1 : 2;
  // int row offsets inside the kernel: M + a tile, and the row widths in
  // bytes, stay below 2**31; the grid's y extent is at most 65535
  if (M >= (1LL << 31) - kBM || K * es >= (1LL << 30) || N * es >= (1LL << 30) ||
      (N + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool vecA = (K * es) % 16 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool vecB = (N * es) % 4 == 0 && (reinterpret_cast<uintptr_t>(b) & 3) == 0;
  const int m = (int)M, n = (int)N, k = (int)K;
  if (mode == 0) {
    if (N <= 64)
      launch<S8, 64>(a, b, out, m, n, k, vecA, vecB, stream);
    else
      launch<S8, 128>(a, b, out, m, n, k, vecA, vecB, stream);
  } else {
    if (N <= 64)
      launch<Bf16, 64>(a, b, out, m, n, k, vecA, vecB, stream);
    else
      launch<Bf16, 128>(a, b, out, m, n, k, vecA, vecB, stream);
  }
  return (int)cudaGetLastError();
}

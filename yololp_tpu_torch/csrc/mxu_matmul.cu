// (M, K) @ B on the tensor cores, for sm_90a: bf16 x bf16 -> fp32 and
// int8 x int8 -> int32, on the shared Hopper mainloop (hopper_gemm.cuh).
//
// Replaces the Pallas TPU kernel tools/probe_mxu_int8.py:_mm_kernel
// (pallas_matmul: a tiled matmul with full-K blocks and B resident, the
// probe of the matrix unit's bf16 and int8 rates). In the port it also runs
// the `dots` lowering of the int8 convs (quant/int8_infer.py:conv3x3_as_dots
// and the 1x1 convs), where K = C and N = O of every int8 conv of the model.
//
// Function. a (M, K) with rows lda elements apart; B either K-major, b_t
// (N, K) with rows ldb apart (int8 or bf16), or, for bf16 only, MN-major,
// b (K, N) with rows ldb apart; out (M, N) row-major, fp32 for bf16 inputs
// and int32 for int8 inputs. Row strides and base addresses are multiples
// of 16 bytes (the wrapper pads a copy where they are not); any M, N, K:
// TMA zero-fills past the edges, and the stores are bounds-checked.
//
// Design: 128 x BN tiles (BN = 16, 64 or 128 by N), walked by a persistent
// grid (one block per SM), a ring of 4-8 stages of 128 bytes of K. One thread of the producer warpgroup loads A and B by TMA
// (128B swizzle) into the ring; two consumer warpgroups run
// wgmma.mma_async m64nBNk32 s8 or m64nBNk16 bf16 from shared memory, one
// group in flight. 8-bit wgmma takes K-major operands only, so int8 B comes
// as b_t; bf16 B is read as (K, N) with the descriptor's transpose bit
// (MN-major), with no transposed copy. The epilogue stages the tile in
// shared memory and stores it by TMA (or 16-byte stores at a ragged edge).
//
// What bounds it on an H100: at the probe's shapes, (16384, 512) @ (512, 512)
// in bf16 moves 17.3 MB in and 33.6 MB out against 8.6 GFLOP: bytes (15.2 us
// at 3.35 TB/s); (4096, 2048) @ (2048, 2048) is 34.4 GFLOP: operations
// (34.7 us of the 989 TFLOP/s bf16 peak, 17.4 us of the 1979 TOP/s int8
// peak). The fp32 / int32 output is most of the bytes at small K.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using hg::kBM;
using hg::kKB;

constexpr int kThreads = 128 + hg::kConsumers;  // one producer warpgroup (one thread loads)

template <class T, int BN, bool kMn>
__global__ void __launch_bounds__(kThreads, 1)
    mxu_matmul_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap omap, typename T::Acc* __restrict__ out,
                      long long ldo, int M, int N, int K, int stages, int use_tma) {
  using Acc = typename T::Acc;
  extern __shared__ uint8_t smem_raw[];
  const hg::Ring r = hg::carve(smem_raw, BN, sizeof(Acc), stages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hg::mbar_init(&r.full[s], 1);   // the producer's arrive.expect_tx
      hg::mbar_init(&r.empty[s], 2);  // one arrival per consumer warpgroup
    }
    hg::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int NT = (N + BN - 1) / BN;
  const int tiles = (M + kBM - 1) / kBM * NT;
  const int KT = (K * T::kEs + kKB - 1) / kKB;
  if (wg == 0) {
    if (threadIdx.x == 0) {
      constexpr int kElems = kKB / T::kEs;  // K elements a stage
      hg::ProducerRing p;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / NT * kBM, n0 = tile % NT * BN;
        for (int kt = 0; kt < KT; ++kt, p.next(stages)) {
          p.wait_empty(r);
          hg::mbar_arrive_expect_tx(&r.full[p.s], hg::stage_bytes(BN));
          hg::tma_load_2d(hg::smem_u32(r.a + p.s * kBM * kKB), &amap, &r.full[p.s], kt * kElems,
                          m0);
          const uint32_t b = hg::smem_u32(r.b + p.s * BN * kKB);
          if (kMn) {
#pragma unroll
            for (int q = 0; q < BN / 64; ++q)
              hg::tma_load_2d(b + q * 64 * kKB, &bmap, &r.full[p.s], n0 + 64 * q, kt * kElems);
          } else {
            hg::tma_load_2d(b, &bmap, &r.full[p.s], kt * kElems, n0);
          }
        }
      }
    }
  } else {
    const int cw = wg - 1;
    int s = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / NT * kBM, n0 = tile % NT * BN;
      Acc acc[BN / 2];
      hg::consume<T, BN, kMn, false>(acc, r, stages, KT, cw, s, phase);
      hg::store_tile<BN>(acc, [](Acc v, int) { return v; }, r, cw, &omap, use_tma != 0, out,
                         ldo, M, N, m0 + 64 * cw, n0);
    }
    hg::store_drain();
  }
}

template <class T, int BN, bool kMn>
int launch(const void* a, long long lda, const void* b, long long ldb, void* out, long long M,
           long long N, long long K, cudaStream_t stream) {
  using Acc = typename T::Acc;
  constexpr CUtensorMapDataType kIn =
      T::kEs == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapDataType kOut =
      T::kEs == 1 ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr unsigned kElems = kKB / T::kEs;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap amap, bmap, omap;
  bool use_tma = false;
  int err = hg::encode_2d(&amap, kIn, a, K, M, lda * T::kEs, kElems, kBM, sw);
  if (!err)
    err = kMn ? hg::encode_2d(&bmap, kIn, b, N, K, ldb * T::kEs, 64, kElems, sw)
              : hg::encode_2d(&bmap, kIn, b, K, N, ldb * T::kEs, kElems, BN, sw);
  if (!err) err = hg::output_map(&omap, &use_tma, kOut, sizeof(Acc), out, M, N, BN);
  if (err) return err;
  const int stages = hg::plan_stages(BN, sizeof(Acc));
  const int smem = hg::smem_bytes(BN, sizeof(Acc), stages);
  int blocks = 0;
  err = hg::prepare<mxu_matmul_kernel<T, BN, kMn>>(
      kThreads, smem, (M + kBM - 1) / kBM * ((N + BN - 1) / BN), &blocks);
  if (err) return err;
  mxu_matmul_kernel<T, BN, kMn><<<blocks, kThreads, smem, stream>>>(
      amap, bmap, omap, static_cast<Acc*>(out), N, (int)M, (int)N, (int)K, stages, (int)use_tma);
  return (int)cudaGetLastError();
}

template <class T, bool kMn>
int launch_bn(const void* a, long long lda, const void* b, long long ldb, void* out, long long M,
              long long N, long long K, cudaStream_t stream) {
  switch (hg::tile_n(N)) {
    case 16:
      if constexpr (!kMn) return launch<T, 16, kMn>(a, lda, b, ldb, out, M, N, K, stream);
      return (int)cudaErrorInvalidValue;  // MN-major panels are 64 columns wide
    case 64:
      return launch<T, 64, kMn>(a, lda, b, ldb, out, M, N, K, stream);
    default:
      return launch<T, 128, kMn>(a, lda, b, ldb, out, M, N, K, stream);
  }
}

}  // namespace

// a (M, K), rows lda elements apart; mode 0: int8 inputs, out int32; mode 1:
// bf16 inputs, out fp32. b_mn 0: b is b_t (N, K), rows ldb apart; b_mn 1
// (bf16 only, N > 16): b is (K, N), rows ldb apart. out (M, N) contiguous.
// Row strides and base addresses of a and b multiples of 16 bytes. Launches
// on `stream`, allocates nothing, returns 0, a cudaError_t, or one of
// hopper_gemm.cuh's tensor-map codes. The library links its own CUDA
// runtime, hence `device`.
extern "C" int mxu_matmul_launch(const void* a, long long lda, const void* b, long long ldb,
                                 int b_mn, void* out, long long M, long long N, long long K,
                                 int mode, int device, cudaStream_t stream) {
  if ((mode != 0 && mode != 1) || (b_mn && mode != 1) || M <= 0 || N <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  const long long es = mode == 0 ? 1 : 2;
  if ((lda * es) % 16 || (ldb * es) % 16 || (reinterpret_cast<uintptr_t>(a) & 15) ||
      (reinterpret_cast<uintptr_t>(b) & 15))
    return (int)cudaErrorInvalidValue;
  // int coordinates, row counts and tile numbers inside the kernel
  if (M >= (1LL << 31) - hg::kBM || K >= (1LL << 31) || N >= (1LL << 31) ||
      (M + hg::kBM - 1) / hg::kBM * ((N + 15) / 16) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (mode == 0) return launch_bn<hg::S8, false>(a, lda, b, ldb, out, M, N, K, stream);
  if (b_mn) return launch_bn<hg::Bf16, true>(a, lda, b, ldb, out, M, N, K, stream);
  return launch_bn<hg::Bf16, false>(a, lda, b, ldb, out, M, N, K, stream);
}

// The plan of a launch with N output columns: {tile rows, tile columns,
// stages, dynamic shared memory bytes}.
extern "C" void mxu_matmul_plan(long long N, int* plan) {
  const int bn = hg::tile_n(N);
  const int stages = hg::plan_stages(bn, 4);
  plan[0] = hg::kBM;
  plan[1] = bn;
  plan[2] = stages;
  plan[3] = hg::smem_bytes(bn, 4, stages);
}

// The shared Hopper (sm_90a) GEMM mainloop of csrc/int8_conv.cu and
// csrc/mxu_matmul.cu: a ring of shared-memory stages guarded by full/empty
// mbarriers, producer warpgroups, two consumer warpgroups that run
// wgmma.mma_async from shared memory, and an epilogue staged in shared memory.
//
// A block computes a kBM x BN tile of C = A B^T (BN in {16, 64, 128}). Each
// stage holds kKB = 128 bytes of K: the A tile (kBM rows x 128 B, K-major)
// and the B tile (BN rows x 128 B K-major, or, for bf16 B stored (K, N),
// 64 K-rows x BN columns in 64-column panels: MN-major). Both are laid out
// as TMA writes them with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk j of
// row r lies at chunk j ^ (r % 8) of the row, every tile 1024-byte aligned.
// A producer that gathers A itself (the conv) writes the same layout with
// cp.async. One stage is one swizzle row of K, so a wgmma descriptor walks
// it in 4 steps of 32 bytes (k32 for s8, k16 for bf16).
//
// The launch is persistent: one block per SM (as many as fit) walks the
// tiles blockIdx.x, blockIdx.x + gridDim.x, ..., and the ring runs on from
// tile to tile, so the producer loads the next tile while the consumers
// store this one. The first warpgroups produce (one for the matmul, whose
// loads are TMA; two for the conv, whose A is gathered): they wait for a
// stage to be empty, load it and let the full barrier count the bytes (TMA)
// or their threads' copies (cp.async.mbarrier.arrive.noinc). The last two
// warpgroups consume: each owns 64 rows of the tile, waits for a stage to
// be full, issues its 4 wgmmas, commits them and waits until at most one
// group is in flight (wait_group 1), then releases the stage before: one
// group of wgmmas always overlaps the next stage's wait.
//
// The epilogue converts the accumulator per element (a functor), writes the
// tile to shared memory in 128-byte swizzled row panels and stores it with
// TMA where whole panels fit and rows start on 16 bytes, else with 16-byte
// bounds-checked stores (per element at the ragged column edge), or, where
// rows do not start on 16 bytes (N = 277), one element a thread, coalesced.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched from the driver
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace hg {

constexpr int kBM = 128;           // tile rows: two consumer warpgroups of 64
constexpr int kKB = 128;           // bytes of K a stage: one 128-byte swizzle row
constexpr int kConsumers = 256;    // two consumer warpgroups, after the producers'
constexpr int kMaxStages = 8;
constexpr int kPanel = 64 * 128;   // one 64-row, 128-byte-row panel of the staged output
constexpr int kSmemMax = 232448;   // 227 KB, the most a block may use
constexpr int kTail = 2048 + 2 * kMaxStages * 8;  // epilogue constants, then barriers

struct S8 {
  using Acc = int;
  static constexpr int kEs = 1;
};
struct Bf16 {
  using Acc = float;
  static constexpr int kEs = 2;
};

// ---- the plan a launch takes (host and device) ----

// tile width for N output columns: the wgmma N that covers it
__host__ __device__ inline int tile_n(long long n) { return n <= 16 ? 16 : (n <= 64 ? 64 : 128); }

__host__ __device__ inline int out_panels(int bn, int es_out) { return (bn * es_out + 127) / 128; }

__host__ __device__ inline int staging_bytes(int bn, int es_out) {
  return 2 * out_panels(bn, es_out) * kPanel;
}

__host__ __device__ inline int stage_bytes(int bn) { return (kBM + bn) * kKB; }

// as many stages as 227 KB holds beside the staging area, at most kMaxStages
inline int plan_stages(int bn, int es_out) {
  const int s = (kSmemMax - 1024 - kTail - staging_bytes(bn, es_out)) / stage_bytes(bn);
  return s < kMaxStages ? s : kMaxStages;
}

// dynamic shared memory of a launch: 1024 of alignment slack, the ring, the
// staging area and the tail
inline int smem_bytes(int bn, int es_out, int stages) {
  return 1024 + stages * stage_bytes(bn) + staging_bytes(bn, es_out) + kTail;
}

// Once per kernel instance and device: allow its dynamic shared memory and
// count how many blocks fit on an SM. Then *blocks = the blocks of a
// persistent launch over `tiles` tiles: as many as fit on the card at once,
// at most one per tile. Returns 0 or a cudaError_t.
template <auto kKernel>
inline int prepare(int threads, int smem, long long tiles, int* blocks) {
  static int per_sm[16] = {}, sms[16] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device < 0 || device >= 16) return (int)cudaErrorInvalidDevice;
  if (per_sm[device] == 0) {
    e = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    int n = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kKernel, threads, smem);
    if (e != cudaSuccess) return (int)e;
    per_sm[device] = n > 0 ? n : 1;
  }
  const long long most = (long long)sms[device] * per_sm[device];
  *blocks = (int)(tiles < most ? tiles : most);
  return 0;
}

struct Ring {
  uint8_t* a;       // stages x kBM x 128 B
  uint8_t* b;       // stages x BN x 128 B
  uint8_t* out;     // 2 consumer warpgroups x panels x kPanel
  float* ab;        // 2 consumer warpgroups x (a[128], b[128])
  uint64_t* full;   // kMaxStages
  uint64_t* empty;  // kMaxStages
};

__device__ __forceinline__ Ring carve(uint8_t* raw, int bn, int es_out, int stages) {
  uint8_t* p = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  Ring r;
  r.a = p;
  p += stages * kBM * kKB;
  r.b = p;
  p += stages * bn * kKB;
  r.out = p;
  p += staging_bytes(bn, es_out);
  r.ab = reinterpret_cast<float*>(p);
  p += 2048;
  r.full = reinterpret_cast<uint64_t*>(p);
  r.empty = r.full + kMaxStages;
  return r;
}

// ---- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed; a
// wait of 2**24 polls (a second or more; a stage takes microseconds) traps,
// so that a pipeline fault ends the launch with an error instead of hanging
// the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (polls == (1u << 24)) asm volatile("trap;");
  }
}

// 16 bytes global -> shared, or 16 zero bytes when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

// one arrival on the barrier once this thread's earlier cp.asyncs have landed
// (noinc: the arrival is one of those the barrier was initialised to expect)
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// generic-proxy shared-memory writes made visible to the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's committed TMA stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... and have written global memory
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of the accumulator above wgmma_wait
template <int N>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout 1 = 128B swizzle
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// ---- wgmma.mma_async, one warpgroup, 64 x N, both operands in shared memory ----
// (d: the N/2 accumulator registers of this thread; scale-d = 1, so the
// caller zeroes d before the first step)

__device__ __forceinline__ void wgmma_s8_n16(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n64(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_bf16_n16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_bf16_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_bf16_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int BN, bool kMn>
__device__ __forceinline__ void mma_step(int* d, uint64_t da, uint64_t db) {
  static_assert(!kMn, "8-bit wgmma takes K-major operands only");
  if constexpr (BN == 16) wgmma_s8_n16(d, da, db);
  else if constexpr (BN == 64) wgmma_s8_n64(d, da, db);
  else wgmma_s8_n128(d, da, db);
}

template <int BN, bool kMn>
__device__ __forceinline__ void mma_step(float* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 16) wgmma_bf16_n16<kMn ? 1 : 0>(d, da, db);
  else if constexpr (BN == 64) wgmma_bf16_n64<kMn ? 1 : 0>(d, da, db);
  else wgmma_bf16_n128<kMn ? 1 : 0>(d, da, db);
}

// ---- the consumer mainloop ----

// Warpgroup `cw` (0 or 1) of the consumers: acc (BN/2 registers) = its 64
// rows of A times B over the next KT stages of the ring, from stage s of
// phase `phase` (both carried from tile to tile). Every stage is released
// once its wgmmas are done. kFenceA: A arrives by cp.async (generic proxy)
// and is made visible to wgmma after the full barrier.
template <class T, int BN, bool kMn, bool kFenceA>
__device__ __forceinline__ void consume(typename T::Acc* acc, const Ring& r, int stages, int KT,
                                        int cw, int& s, uint32_t& phase) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const uint32_t a0 = smem_u32(r.a) + cw * 64 * kKB;
  const uint32_t b0 = smem_u32(r.b);
  const bool leader = (threadIdx.x & 127) == 0;
  int prev = -1;
  for (int kt = 0; kt < KT; ++kt) {
    mbar_wait(&r.full[s], phase);
    if (kFenceA) fence_proxy_async();
    wgmma_fence();
    const uint32_t a = a0 + s * kBM * kKB;
    const uint32_t b = b0 + s * BN * kKB;
#pragma unroll
    for (int k = 0; k < kKB / 32; ++k) {
      // K-major: a k-step is 32 bytes along the swizzled row, 8-row groups
      // 1024 bytes apart. MN-major (bf16 B as (K, N)): a k16 step is 16
      // K-rows (2048 bytes), 64-column panels 64 x 128 bytes apart.
      const uint64_t da = desc_sw128(a + 32 * k, 16, 1024);
      const uint64_t db = kMn ? desc_sw128(b + 2048 * k, 64 * kKB, 1024)
                              : desc_sw128(b + 32 * k, 16, 1024);
      mma_step<BN, kMn>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<BN / 2>(acc);
    if (prev >= 0 && leader) mbar_arrive(&r.empty[prev]);
    prev = s;
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs<BN / 2>(acc);
  if (prev >= 0 && leader) mbar_arrive(&r.empty[prev]);
}

// The producer's side of the ring: wait until stage s is free (its first
// use passes at once), then step to the next.
struct ProducerRing {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void wait_empty(const Ring& r) { mbar_wait(&r.empty[s], phase ^ 1); }
  __device__ __forceinline__ void next(int stages) {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
};

// ---- the epilogue ----

template <class Out>
struct __align__(2 * sizeof(Out)) Pair {
  Out v[2];
};

// byte offset of byte `byte` of row `row` in the staged panels
__device__ __forceinline__ int staged(int row, int byte) {
  return (byte >> 7) * kPanel + row * 128 + ((((byte >> 4) & 7) ^ (row & 7)) << 4) + (byte & 15);
}

// Consumer warpgroup `cw` writes its 64 x BN part of the tile: f(acc, col)
// gives the Out value of an accumulator element in tile column col. Rows
// m0.. (this warpgroup's first row) and columns n0.. of out (row stride
// ldo elements, M x N). use_tma: whole 128-byte panels, 16-byte rows, and
// omap describes out with a box of (128 / sizeof(Out)) x 64.
template <int BN, class Out, class Acc, class F>
__device__ __forceinline__ void store_tile(const Acc* acc, F f, const Ring& r, int cw,
                                           const CUtensorMap* omap, bool use_tma, Out* out,
                                           long long ldo, int M, int N, int m0, int n0) {
  constexpr int kEs = sizeof(Out);
  uint8_t* stg = r.out + cw * out_panels(BN, kEs) * kPanel;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  // the last tile's store (TMA, still in flight, or the copy-out below) has
  // read the staging area
  if (use_tma && t == 0) tma_store_wait_read();
  named_bar_sync(1 + cw, 128);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // wgmma's accumulator layout: element 4j + 2h + e of a thread is at
      // row 16 warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
      const int row = warp * 16 + (lane >> 2) + 8 * h;
      const int col = 8 * j + 2 * (lane & 3);
      Pair<Out> p;
      p.v[0] = f(acc[4 * j + 2 * h], col);
      p.v[1] = f(acc[4 * j + 2 * h + 1], col + 1);
      *reinterpret_cast<Pair<Out>*>(stg + staged(row, col * kEs)) = p;
    }
  }
  if (use_tma) fence_proxy_async();
  named_bar_sync(1 + cw, 128);
  if (use_tma) {
    if (t == 0) {
#pragma unroll
      for (int p = 0; p < out_panels(BN, kEs); ++p)
        tma_store_2d(omap, smem_u32(stg + p * kPanel), n0 + p * (128 / kEs), m0);
      tma_store_commit();  // waited for at the next tile's epilogue, or by store_drain
    }
    return;
  }
  if (((ldo * kEs) & 15) != 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    // rows that do not start on 16 bytes: one element a thread, a warp's
    // 32 threads on 32 neighbouring columns of a row
    for (int i = t; i < 64 * BN; i += 128) {
      const int row = i / BN, col = i % BN;
      const int m = m0 + row, n = n0 + col;
      if (m < M && n < N)
        out[(long long)m * ldo + n] = *reinterpret_cast<const Out*>(stg + staged(row, col * kEs));
    }
    return;
  }
  constexpr int kCpr = BN * kEs / 16;  // 16-byte chunks a row
  constexpr int kPer = 16 / kEs;       // elements a chunk
  for (int i = t; i < 64 * kCpr; i += 128) {
    const int row = i / kCpr, ch = i % kCpr;
    const int m = m0 + row;
    if (m >= M) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(stg + staged(row, ch * 16));
    const int col = n0 + ch * kPer;
    Out* dst = out + (long long)m * ldo + col;
    if (col + kPer <= N) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const Out* e = reinterpret_cast<const Out*>(&v);
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        if (col + q < N) dst[q] = e[q];
    }
  }
}

// After a consumer warpgroup's last tile: its TMA stores are complete before
// the block ends.
__device__ __forceinline__ void store_drain() {
  if ((threadIdx.x & 127) == 0) tma_store_wait_all();
}

// ---- host: tensor maps ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, taken from the driver through the runtime (so the
// library needs no -lcuda); null if the driver does not have it
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes of the launchers beside cudaError_t: the encoder is missing,
// or it refused a map (10000 + its CUresult).
constexpr int kNoEncoder = 9999;
constexpr int kEncodeError = 10000;

// A 2-d map of `outer` rows of `inner` elements, rows `row_bytes` apart,
// boxes of box_inner x box_outer; elements past the edges read as zero.
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                     unsigned long long inner, unsigned long long outer,
                     unsigned long long row_bytes, unsigned box_inner, unsigned box_outer,
                     CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// The output map of store_tile's TMA path, or use_tma = false where it
// does not apply (partial panels, rows not on 16 bytes).
inline int output_map(CUtensorMap* map, bool* use_tma, CUtensorMapDataType type, int es,
                      const void* out, long long M, long long N, int bn) {
  *use_tma = (bn * es) % 128 == 0 && (N * es) % 16 == 0 &&
             (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (!*use_tma) {
    memset(map, 0, sizeof(*map));
    return 0;
  }
  return encode_2d(map, type, out, N, M, N * es, 128 / es, 64, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace hg

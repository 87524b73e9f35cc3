// The NMS gate in one pass, for sm_90a: from each row of the (B, A, 290) fp32
// decode, the xyxy box, the 8 task maxima and first argmaxima of cls * obj,
// the mean-of-8 score, the gate and the 24 columns the top-K gathers from.
//
// Replaces no Pallas kernel: XLA fused the gate's reductions into one pass
// on the TPU. On the card PyTorch ran it as some 30 kernels (8 amax and 8
// argmax reductions over strided slices of 31, 24 and 37 columns, the
// multiply by obj over the 277 score columns, stacks, the box's concat, the
// `rest` concat), each re-reading the decode or a large part of it.
//
// The arithmetic is the plain sequence's (ops/cuda_nms_gate.py:
// nms_gate_plain), bit for bit:
//   - each score is cls * obj in fp32 (__fmul_rn), then each task's maximum
//     and first argmax over the products, as torch.amax / torch.argmax on the
//     card: a NaN counts as the maximum and the first NaN is the argmax;
//   - the score sums the 8 maxima left to right and divides by 8 (PyTorch's
//     CUDA division by a Python scalar multiplies by its reciprocal; 1/8 is
//     exact, so both round the same value); with compat_ad4_bug the gate's
//     sum takes columns 0..5, 6, 6;
//   - the gate compares in fp32 against conf_thres rounded to fp32, as
//     PyTorch compares an fp32 tensor with a Python float;
//   - the box is (cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5).
// The file is built with -fmad=false and every operation is an explicitly
// rounded intrinsic, so nothing contracts into an FMA.
//
// What bounds it on an H100: bytes. It reads the decode once, 1160 bytes a
// row (1.247 GB at B = 128, A = 8400), and writes 117 bytes a row (box 16,
// score 4, rest 96, passed 1): 1.373 GB, 0.41 ms at 3.35 TB/s. About 280
// fp32 multiplies and compares a row are a small share of the SMs' issue
// rate. The design keeps the memory system busy:
//
//   1. A persistent grid, kBlocksPerSm blocks an SM, walks tiles of kRows =
//      32 rows: 37,120 contiguous bytes, 16-byte aligned at every tile when
//      the decode's base is. Each block copies a tile into shared memory with
//      16-byte cp.async (4-byte copies where a tile's start or length is not
//      a multiple of 16: an offset view, or the last tile's odd row count),
//      two stages deep, so the next tile's copy runs while this one is
//      reduced: three blocks an SM hold six tiles, three arriving while
//      three are reduced. At 128 x 8400 it ran at 87% of the bound (an
//      H100 at 700 W).
//   2. One thread a (row, task): 256 threads scan the 32 rows' 8 tasks, each
//      its 31, 24 or 37 products, in shared memory. A row's 8 threads are 8
//      neighbouring lanes; shuffles hand each of them the row's 8 maxima,
//      and the first of them sums them in task order.
//   3. Stores: the row's 8 threads write rest's corners, maxima and argmax
//      ids (each a full 32-byte sector), its first 4 the box's coordinates;
//      the first writes the gated score and the pass flag.
//   4. The host launcher launches on the caller's stream, allocates nothing,
//      and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 290;      // the decode's columns
constexpr int kScore0 = 13;     // the first score column (after box, obj, corners)
constexpr int kTasks = 8;       // province, alphabet, 6 characters
constexpr int kRestCols = 24;   // corners 8, maxima 8, argmax ids 8
constexpr int kRows = 32;       // rows a tile
constexpr int kThreads = kRows * kTasks;
constexpr int kTileFloats = kRows * kCols;
constexpr int kStages = 2;
constexpr int kBlocksPerSm = 3;  // 3 x 74,240 B of shared memory: the SM's 228 KB
constexpr int kMaxDevices = 16;
constexpr size_t kSmemBytes = (size_t)kStages * kTileFloats * sizeof(float);

// the first score column of task k (province 31, alphabet 24, 6 x 37 characters)
__device__ __forceinline__ int task_begin(int k) { return k < 2 ? k * 31 : 55 + (k - 2) * 37; }
__device__ __forceinline__ int task_width(int k) { return k == 0 ? 31 : k == 1 ? 24 : 37; }

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int tile_rows(long long tile, long long n_rows) {
  const long long left = n_rows - tile * kRows;
  return left < kRows ? (int)left : kRows;
}

// Start the copy of `rows` rows from row `row0` into `dst`; the caller commits.
__device__ __forceinline__ void load_tile(float* dst, const float* pred, long long row0,
                                          int rows) {
  const float* src = pred + row0 * kCols;
  const int n = rows * kCols;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0) {
    for (int i = threadIdx.x * 4; i < n; i += kThreads * 4) cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) cp_async4(dst + i, src + i);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    nms_gate_kernel(const float* __restrict__ pred, long long n_rows, float thres, int compat,
                    float* __restrict__ box, float* __restrict__ score,
                    float* __restrict__ rest, bool* __restrict__ passed) {
  extern __shared__ __align__(16) float tiles[];  // kStages x kTileFloats
  const long long n_tiles = (n_rows + kRows - 1) / kRows;
  long long tile = blockIdx.x;
  if (tile >= n_tiles) return;
  const int r = threadIdx.x / kTasks;  // the thread's row in the tile
  const int k = threadIdx.x % kTasks;  // its task
  const int lane0 = (threadIdx.x & 31) & ~(kTasks - 1);  // the row's first lane
  const int begin = kScore0 + task_begin(k), width = task_width(k);

  load_tile(tiles, pred, tile * kRows, tile_rows(tile, n_rows));
  cp_async_commit();
  for (int stage = 0; tile < n_tiles; tile += gridDim.x, stage ^= 1) {
    const long long next = tile + gridDim.x;
    if (next < n_tiles)
      load_tile(tiles + (stage ^ 1) * kTileFloats, pred, next * kRows, tile_rows(next, n_rows));
    cp_async_commit();  // an empty group past the last tile keeps the count
    cp_async_wait<1>();
    __syncthreads();

    // A thread past the last tile's rows reduces stale shared memory and
    // stores nothing; it still takes part in the shuffles.
    const float* row = tiles + stage * kTileFloats + r * kCols;
    const float obj = row[4];
    float m = __fmul_rn(row[begin], obj);
    int arg = 0;
    for (int j = 1; j < width; ++j) {
      const float v = __fmul_rn(row[begin + j], obj);
      if (!isnan(m) && (isnan(v) || v > m)) {
        m = v;
        arg = j;
      }
    }
    float c[kTasks];
#pragma unroll
    for (int t = 0; t < kTasks; ++t) c[t] = __shfl_sync(0xffffffffu, m, lane0 + t);

    if (r < tile_rows(tile, n_rows)) {
      const long long g = tile * kRows + r;  // the row over B * A
      float* out = rest + g * kRestCols;
      out[k] = row[5 + k];
      out[kTasks + k] = m;
      out[2 * kTasks + k] = __int2float_rn(arg);
      if (k < 4) {  // x1, y1, x2, y2
        const float half = __fmul_rn(row[2 + (k & 1)], 0.5f);
        box[g * 4 + k] = k < 2 ? __fsub_rn(row[k & 1], half) : __fadd_rn(row[k & 1], half);
      }
      if (k == 0) {
        float sum = c[0];
#pragma unroll
        for (int t = 1; t < kTasks; ++t) sum = __fadd_rn(sum, c[t]);
        const float s = __fmul_rn(sum, 0.125f);
        float gate = s;
        if (compat) {  // the reference sums ad4 twice and omits ad5
          float g_sum = c[0];
#pragma unroll
          for (int t = 1; t < 6; ++t) g_sum = __fadd_rn(g_sum, c[t]);
          g_sum = __fadd_rn(__fadd_rn(g_sum, c[6]), c[6]);
          gate = __fmul_rn(g_sum, 0.125f);
        }
        const bool pass = gate >= thres;
        score[g] = pass ? s : 0.0f;
        passed[g] = pass;
      }
    }
    __syncthreads();  // the stage is refilled next iteration
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" size_t nms_gate_smem_bytes() { return kSmemBytes; }

// pred (n_rows, 290) f32, contiguous; box (n_rows, 4), score (n_rows), rest
// (n_rows, 24) f32 and passed (n_rows) bool, contiguous; all on card
// `device`. conf_thres is rounded to fp32 here. Launches on `stream`,
// allocates nothing, returns the cudaError_t of the launch (0 on success).
// The library links its own CUDA runtime, whose current device is not the
// caller's, hence `device`.
extern "C" int nms_gate_launch(const float* pred, long long n_rows, double conf_thres,
                               int compat, float* box, float* score, float* rest, bool* passed,
                               int device, cudaStream_t stream) {
  if (n_rows <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(pred) & 3) != 0) return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static thread_local int current = -1;
  if (device != current) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    current = device;
  }
  static int sms[kMaxDevices] = {};
  if (!sms[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    sms[device] = count;
  }
  const long long n_tiles = (n_rows + kRows - 1) / kRows;
  const long long cap = (long long)sms[device] * kBlocksPerSm;
  const unsigned blocks = (unsigned)(n_tiles < cap ? n_tiles : cap);
  nms_gate_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(
      pred, n_rows, (float)conf_thres, compat, box, score, rest, passed);
  return (int)cudaGetLastError();
}

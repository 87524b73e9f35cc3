// Exact greedy NMS keep-mask over score-sorted boxes, for sm_90a.
//
// Replaces the Pallas TPU kernel yololp_tpu/ops/pallas_nms.py:_nms_kernel
// (and, on the port's main path, the XLA fixpoint ops/nms.py:greedy_nms_mask
// that the JAX inferer runs). Computes keep_i = (score_i > 0) and no kept
// j < i with IoU(j, i) > thres, i.e. the textbook sequential greedy answer.
//
// IoU is computed in the operation order of ops/geometry.py:pairwise_iou,
// overlap / (area1 + area2 - overlap + 1e-9), with widths, heights and areas
// clipped at 0, with explicitly rounded intrinsics (and the file is built
// with -fmad=false), so no FMA contraction can move an IoU across the
// threshold: the mask equals the plain PyTorch version bit for bit.
// Degenerate boxes (x2 < x1) get area 0, as on the JAX default path; the
// Pallas kernel does not clip areas.
//
// What bounds it on an H100: neither bytes nor operations. It reads
// 20*K*B bytes and writes K*B (~0.35 MB at K = 512, B = 32: ~0.1 us at
// 3.35 TB/s); the K*K/2 IoUs are ~0.9 us of the fp32 rate. What bounds it is
// a serial walk, one dependent step per kept box, plus the launch latency.
// The design keeps everything else off that path:
//
//   1. The bitmask is spread over a thread-block cluster of 8 blocks per
//      image (the portable maximum), so B = 32 runs 256 blocks over the 132
//      SMs and B = 1 runs 8. Every block loads the image's K boxes and
//      areas into its own shared memory and builds a share of the
//      upper-triangular suppression words: bit c of word w in row i means
//      j = 32w + c > i and IoU(i, j) > thres. One __ballot_sync makes one
//      word; a row's words walk j by adds, and only the words from the one
//      holding the diagonal rightwards are made. The rows go to the cluster's 128 warps in a
//      mirrored order (warp q takes rows q, 255 - q, 256 + q, 511 - q, ...),
//      so that a short row near the bottom pairs with a long one near the
//      top and every warp, and every block, gets the same share. A box with
//      score 0 is never kept, so its row is never read and its bit never
//      matters: those rows, and the columns past the last box with a score
//      above 0, are not made (a conf-gated zero tail costs nothing).
//   2. Each warp stores a finished row's words, one lane a word, straight
//      into the leader block's shared memory through distributed shared
//      memory; one cluster barrier then hands the whole K x ceil(K/32) mask
//      (32 KB at K = 512, 128 KB at K = 1024) to the leader.
//   3. One warp of the leader walks the kept rows only. Lane l holds
//      keep-word l (ceil(K/32) <= 32 words): the valid boxes, cleared as kept
//      rows suppress them. The walk goes word by word. Each lane offers the
//      lowest bit of its word if it lies above the current word, and
//      __reduce_min_sync gives the first kept box i of the next word w that
//      holds one (every earlier kept row has been applied, so i is kept).
//      Every lane then copies word w (`cur`), and lane c loads word w of
//      row 32w + c (the diagonal block). Inside the word a step applies row
//      i: each lane clears its keep-word with its word of the row (off the
//      dependent path), and `cur` loses bit i and word w of row i, taken
//      from lane i % 32 by one shuffle; the next kept box is the lowest bit
//      left in `cur`. One step per kept box, not K; one reduction per word
//      that holds a kept box.
//   4. keep is written one byte a slot, 32 slots a warp store.
//   5. The host launcher calls cudaSetDevice only when the device differs
//      from its thread's last call, raises the shared-memory limit once per
//      device (to the K = 1024 size), allocates nothing and returns the
//      launch's cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // blocks per image
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kClusterWarps = kCluster * kWarps;
constexpr int kMaxK = 1024;
constexpr int kMaxDevices = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clip0(float v) { return v > 0.f ? v : 0.f; }

// The release-free half of a cluster barrier: arrive now, wait later.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One row of the suppression bitmask, made by one warp and stored into the
// leader's mask (`lead`, a distributed shared memory pointer). Only the
// columns below `kv` (one past the last box with a score > 0) are made: a
// box with score 0 is never kept, so its bit is never read.
__device__ __forceinline__ void mask_row(const float4* sbox, const float* sarea,
                                         uint32_t* lead, int i, int kv, int W,
                                         float thres, int lane) {
  const float4 a = sbox[i];
  const float area_a = sarea[i];
  const int w0 = i >> 5;  // the word holding i: its bits above i
  const int w1 = (kv + 31) >> 5;
  uint32_t mine = 0;
  int j = (w0 << 5) + lane;
  for (int w = w0; w < w1; ++w, j += 32) {
    bool sup = false;
    if (j > i && j < kv) {
      const float4 c = sbox[j];
      const float iw = clip0(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)));
      const float ih = clip0(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)));
      const float overlap = __fmul_rn(iw, ih);
      // overlap 0 (or NaN) gives IoU 0 (or NaN), above no thres >= 0: the
      // division is skipped, with the same answer
      if (overlap > 0.f || thres < 0.f) {
        const float denom =
            __fadd_rn(__fsub_rn(__fadd_rn(area_a, sarea[j]), overlap), 1e-9f);
        sup = __fdiv_rn(overlap, denom) > thres;
      }
    }
    const uint32_t word = __ballot_sync(kFull, sup);
    if (lane == w) mine = word;
  }
  if (lane >= w0 && lane < w1) lead[i * W + lane] = mine;
}

__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                  bool* __restrict__ keep, int K, float thres) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + K);
  float* sscore = sarea + K;
  uint32_t* mask = reinterpret_cast<uint32_t*>(sscore + K);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int W = (K + 31) >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ int s_kv;
  if (tid == 0) s_kv = 0;
  // Distributed shared memory may be written only once every block of the
  // cluster runs: arrive now, wait just before the first remote store.
  cluster_arrive_relaxed();
  const float4* bx = boxes + (size_t)b * K;
  const float* sc = scores + (size_t)b * K;
  int last = 0;  // one past this thread's last box with a score > 0
  for (int i = tid; i < K; i += kThreads) {
    const float4 v = bx[i];
    sbox[i] = v;
    sarea[i] = __fmul_rn(clip0(__fsub_rn(v.z, v.x)), clip0(__fsub_rn(v.w, v.y)));
    const float s = sc[i];
    sscore[i] = s;
    if (s > 0.f) last = i + 1;
  }
  last = __reduce_max_sync(kFull, last);
  __syncthreads();  // s_kv = 0 is seen before any atomicMax
  if (lane == 0) atomicMax(&s_kv, last);
  __syncthreads();
  const int kv = s_kv;
  cluster_wait();

  // Rows of boxes with score 0 are skipped: the walk reads only kept rows.
  uint32_t* lead = cluster.map_shared_rank(mask, 0);
  const int q = warp * kCluster + rank;  // this warp's place among the cluster's
  for (int base = 0; base < kv; base += 2 * kClusterWarps) {
    const int top = base + q, bottom = base + 2 * kClusterWarps - 1 - q;
    if (top < kv && sscore[top] > 0.f) mask_row(sbox, sarea, lead, top, kv, W, thres, lane);
    if (bottom < kv && sscore[bottom] > 0.f) mask_row(sbox, sarea, lead, bottom, kv, W, thres, lane);
  }
  cluster.sync();  // every row is in the leader's mask
  if (rank != 0 || warp != 0) return;

  uint32_t kw = 0;
  for (int w = 0; w < W; ++w) {
    const int j = (w << 5) + lane;
    const uint32_t word = __ballot_sync(kFull, j < K && sscore[j] > 0.f);
    if (lane == w) kw = word;
  }
  const int wv = (kv + 31) >> 5;
  for (int w = -1;;) {
    // the first pending box of the next word that holds one: it is kept
    const int cand = (lane > w && kw) ? (lane << 5) + __ffs(kw) - 1 : INT_MAX;
    int i = __reduce_min_sync(kFull, cand);
    if (i == INT_MAX) break;
    w = i >> 5;
    // lane c holds word w of row 32w + c (the diagonal block; rows that
    // were not built are never used), and every lane holds word w's
    // pending bits: each further kept box of the word is the lowest bit of
    // `cur`, one shuffle a step on the dependent path
    const uint32_t diag = mask[min((w << 5) + lane, K - 1) * W + w];
    const bool mine = lane >= w && lane < wv;
    uint32_t cur = __shfl_sync(kFull, kw, w);
    for (;;) {
      const uint32_t r = mask[i * W + min(lane, W - 1)];
      kw &= mine ? ~r : kFull;
      cur &= (cur - 1) & ~__shfl_sync(kFull, diag, i & 31);
      if (!cur) break;
      i = (w << 5) + __ffs(cur) - 1;
    }
  }

  bool* out = keep + (size_t)b * K;
  for (int w = 0; w < W; ++w) {
    const uint32_t word = __shfl_sync(kFull, kw, w);
    const int j = (w << 5) + lane;
    if (j < K) out[j] = (word >> lane) & 1u;
  }
}

}  // namespace

extern "C" size_t greedy_nms_smem_bytes(int K) {
  const int W = (K + 31) / 32;
  return (size_t)K * sizeof(float4) + 2 * (size_t)K * sizeof(float) +
         (size_t)K * W * sizeof(uint32_t);
}

// boxes (B, K, 4) f32 xyxy, score-sorted; scores (B, K) f32; keep (B, K) bool,
// all on card `device`. Launches B clusters of 8 blocks on `stream`,
// allocates nothing, returns the cudaError_t of the launch (0 on success).
// The library links its own CUDA runtime, whose current device is not the
// caller's, hence `device`.
extern "C" int greedy_nms_mask_launch(const float* boxes, const float* scores,
                                      bool* keep, int B, int K, float thres,
                                      int device, cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > kMaxK || B > INT_MAX / kCluster) return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static thread_local int current = -1;
  if (device != current) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    current = device;
  }
  static bool ready[kMaxDevices] = {};
  if (!ready[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)greedy_nms_smem_bytes(kMaxK));
    if (err != cudaSuccess) return (int)err;
    ready[device] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = greedy_nms_smem_bytes(K);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, greedy_nms_kernel,
                                             reinterpret_cast<const float4*>(boxes),
                                             scores, keep, K, thres);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

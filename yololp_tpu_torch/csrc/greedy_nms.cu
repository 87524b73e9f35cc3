// Exact greedy NMS keep-mask over score-sorted boxes, for sm_90a.
//
// Replaces the Pallas TPU kernel yololp_tpu/ops/pallas_nms.py:_nms_kernel
// (and, on the port's main path, the XLA fixpoint ops/nms.py:greedy_nms_mask
// that the JAX inferer runs). Computes keep_i = (score_i > 0) and no kept
// j < i with IoU(j, i) > thres, i.e. the textbook sequential greedy answer.
//
// Design: one block per image.
//   1. The K boxes and their areas go to shared memory (20 B a box).
//   2. The block builds the upper-triangular suppression bitmask,
//      K x ceil(K/32) uint32 words in shared memory: bit j of row i means
//      j > i and IoU(i, j) > thres. One warp makes one word with __ballot_sync,
//      lane c computing column 32*w + c.
//   3. Warp 0 walks the rows. Lane l holds keep-word l (K <= 1024, so one
//      word a lane); for i = 0..K-1 the owning lane broadcasts bit i with
//      __shfl_sync, and when it is set every lane clears its word with row i.
//   4. keep is written as bool (one byte a slot).
//
// IoU is computed in the operation order of ops/geometry.py:pairwise_iou,
// overlap / (area1 + area2 - overlap + 1e-9), with widths, heights and areas
// clipped at 0, with explicitly rounded intrinsics (and the file is built
// with -fmad=false), so no FMA contraction can move an IoU across the
// threshold: the mask equals the plain PyTorch version bit for bit.
// Degenerate boxes (x2 < x1) get area 0, as on the JAX default path; the
// Pallas kernel does not clip areas.
//
// What bounds it on an H100: not memory. It reads 16*K*B + 4*K*B bytes and
// writes K*B; at K = 512, B = 32 that is ~0.35 MB, ~0.1 us at 3.35 TB/s.
// The K*K/2 IoUs (~4 M at B = 32) are ~0.1 us of the card's fp32 rate. What
// bounds it is the K-step serial walk of one warp (a dependent shuffle and a
// shared load each step) and the launch latency; B blocks cover only B of
// the 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 1024;

__device__ __forceinline__ float clip0(float v) { return v > 0.f ? v : 0.f; }

__global__ void greedy_nms_kernel(const float4* __restrict__ boxes,
                                  const float* __restrict__ scores,
                                  bool* __restrict__ keep, int K, float thres) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + K);
  uint32_t* mask = reinterpret_cast<uint32_t*>(sarea + K);

  const int W = (K + 31) >> 5;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float4* bx = boxes + (size_t)b * K;

  for (int i = tid; i < K; i += blockDim.x) {
    float4 v = bx[i];
    sbox[i] = v;
    sarea[i] = __fmul_rn(clip0(__fsub_rn(v.z, v.x)), clip0(__fsub_rn(v.w, v.y)));
  }
  __syncthreads();

  // suppression bitmask, one (row, word) per warp iteration
  for (int t = warp; t < K * W; t += nwarps) {
    const int i = t / W;
    const int w = t - i * W;
    if ((w << 5) + 31 <= i) {  // the whole word lies at or below the diagonal
      if (lane == 0) mask[t] = 0u;
      continue;
    }
    const int j = (w << 5) + lane;
    bool sup = false;
    if (j > i && j < K) {
      const float4 a = sbox[i];
      const float4 c = sbox[j];
      const float iw = clip0(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)));
      const float ih = clip0(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)));
      const float overlap = __fmul_rn(iw, ih);
      const float denom =
          __fadd_rn(__fsub_rn(__fadd_rn(sarea[i], sarea[j]), overlap), 1e-9f);
      sup = __fdiv_rn(overlap, denom) > thres;
    }
    const uint32_t word = __ballot_sync(0xffffffffu, sup);
    if (lane == 0) mask[t] = word;
  }
  __syncthreads();

  if (warp != 0) return;
  const float* sc = scores + (size_t)b * K;
  uint32_t kw = 0;
  if (lane < W) {
    for (int c = 0; c < 32; ++c) {
      const int j = (lane << 5) + c;
      if (j < K && sc[j] > 0.f) kw |= 1u << c;
    }
  }
  for (int i = 0; i < K; ++i) {
    const uint32_t owner = __shfl_sync(0xffffffffu, kw, i >> 5);
    if ((owner >> (i & 31)) & 1u) {
      if (lane < W) kw &= ~mask[i * W + lane];
    }
  }
  bool* out = keep + (size_t)b * K;
  if (lane < W) {
    for (int c = 0; c < 32; ++c) {
      const int j = (lane << 5) + c;
      if (j < K) out[j] = (kw >> c) & 1u;
    }
  }
}

}  // namespace

extern "C" size_t greedy_nms_smem_bytes(int K) {
  const int W = (K + 31) / 32;
  return (size_t)K * sizeof(float4) + (size_t)K * sizeof(float) +
         (size_t)K * W * sizeof(uint32_t);
}

// boxes (B, K, 4) f32 xyxy, score-sorted; scores (B, K) f32; keep (B, K) bool,
// all on card `device`. Launches on `stream`, allocates nothing, returns the
// cudaError_t of the launch (0 on success). The library links its own CUDA
// runtime, whose current device is not the caller's, hence `device`.
extern "C" int greedy_nms_mask_launch(const float* boxes, const float* scores,
                                      bool* keep, int B, int K, float thres,
                                      int device, cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = greedy_nms_smem_bytes(K);
  err = cudaFuncSetAttribute(
      greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  greedy_nms_kernel<<<B, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, keep, K, thres);
  return (int)cudaGetLastError();
}

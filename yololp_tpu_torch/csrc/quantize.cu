// Float -> int8 codes in one pass, for sm_90a: out[i] = (int8) clip(rint(x[i] *
// inv_scale), -128, 127) over a bf16 or fp32 tensor, the input quantize of
// every int8 conv of the int8 plan (a per-tensor scale; inv_scale is the
// host's fp32 reciprocal of it).
//
// Replaces no Pallas kernel: XLA fused this loop into the input of its int8
// conv on the TPU. PyTorch runs the same expression, round(x.float() *
// inv_scale).clamp(-128, 127).to(int8), as five passes (the widening to
// fp32, the multiply, the round, the clamp, the narrowing), 35 bytes moved an
// element of bf16 input. This kernel reads each element once and writes its
// code once: 3 bytes an element from bf16, 5 from fp32.
//
// The arithmetic is those passes', so the codes are theirs bit for bit: the
// bf16 -> fp32 widening is exact, then one fp32 multiply rounded to nearest
// (__fmul_rn; the build passes -fmad=false besides), rintf (half to even, as
// torch.round), the clamp, and the conversion. NaN passes the clamp as NaN
// and converts to 0, as PyTorch's clamp and cast do on the card.
//
// What bounds it on an H100: bytes. A yololps b128 batch of the int8 plan
// quantizes 2.19 G elements in 32 calls, all bf16: 6.57 GB, 1.96 ms at 3.35
// TB/s. The design is for bandwidth, as csrc/bias_act.cu's:
//
//   1. The function is elementwise and the tensor dense, so the kernel sees
//      one flat array in memory order and ignores the layout; the output has
//      the input's strides (the launcher allocates it so), so a channels_last
//      input gives channels_last codes.
//   2. Each thread loads 16-byte vectors (8 bf16 or 4 fp32 values) and stores
//      their 8 or 4 codes as one 8- or 4-byte word, neighbouring threads on
//      neighbouring addresses, two vectors in flight a step, in a grid-stride
//      loop over a grid sized to the SMs.
//   3. A count that is not a multiple of the vector ends in a scalar tail; an
//      input whose base is not 16-byte aligned (an offset view), or an output
//      not aligned to its word, runs the scalar kernel throughout.
//   4. The host launcher launches on the caller's stream, allocates nothing,
//      and returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 threads: a full SM
constexpr int kMaxDevices = 16;

struct F32 {
  using S = float;
  using Codes = uint32_t;  // 4 codes
  static constexpr int kVec = 4;
  __device__ __forceinline__ static float load(S v) { return v; }
};

struct Bf16 {
  using S = uint16_t;
  using Codes = uint2;  // 8 codes
  static constexpr int kVec = 8;
  __device__ __forceinline__ static float load(S v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
};

__device__ __forceinline__ int8_t code(float v, float inv_scale) {
  float r = rintf(__fmul_rn(v, inv_scale));
  r = r < -128.f ? -128.f : (r > 127.f ? 127.f : r);  // NaN stays NaN
  return (int8_t)__float2int_rz(r);                    // and converts to 0
}

template <class T>
union Vec {
  uint4 u;
  typename T::S e[T::kVec];
};

template <class T>
union Packed {
  typename T::Codes u;
  int8_t e[T::kVec];
};

template <class T>
__device__ __forceinline__ typename T::Codes codes(const Vec<T>& in, float inv_scale) {
  Packed<T> c;
#pragma unroll
  for (int i = 0; i < T::kVec; ++i) c.e[i] = code(T::load(in.e[i]), inv_scale);
  return c.u;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const typename T::S* __restrict__ x, int8_t* __restrict__ out, long long n,
                    float inv_scale) {
  constexpr int V = T::kVec;
  const long long nvec = n / V;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  auto* o = reinterpret_cast<typename T::Codes*>(out);
  long long v = first;
  for (; v + stride < nvec; v += 2 * stride) {  // two loads in flight
    Vec<T> a, b;
    a.u = __ldcs(x4 + v);  // read once: evict first
    b.u = __ldcs(x4 + v + stride);
    o[v] = codes<T>(a, inv_scale);
    o[v + stride] = codes<T>(b, inv_scale);
  }
  if (v < nvec) {
    Vec<T> a;
    a.u = __ldcs(x4 + v);
    o[v] = codes<T>(a, inv_scale);
  }
  const long long tail = nvec * V + first;  // the last n % V elements
  if (tail < n) out[tail] = code(T::load(x[tail]), inv_scale);
}

// Any base alignment: one element a thread a step.
template <class T>
__global__ void __launch_bounds__(kThreads)
    quantize_scalar_kernel(const typename T::S* __restrict__ x, int8_t* __restrict__ out,
                           long long n, float inv_scale) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n; e += stride)
    out[e] = code(T::load(x[e]), inv_scale);
}

template <class T>
cudaError_t launch(const void* x, void* out, long long n, float inv_scale, int sms,
                   cudaStream_t stream) {
  const auto* xs = static_cast<const typename T::S*>(x);
  auto* os = static_cast<int8_t*>(out);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % sizeof(typename T::Codes) == 0;
  const long long work = aligned ? (n / T::kVec > 0 ? n / T::kVec : 1) : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const dim3 grid((unsigned)blocks), block(kThreads);
  if (aligned) {
    quantize_kernel<T><<<grid, block, 0, stream>>>(xs, os, n, inv_scale);
  } else {
    quantize_scalar_kernel<T><<<grid, block, 0, stream>>>(xs, os, n, inv_scale);
  }
  return cudaGetLastError();
}

}  // namespace

// x: n elements of `dtype` (0 float32, 1 bfloat16) in memory order; out: n
// int8 codes in the same order; both on card `device`. Launches on `stream`,
// allocates nothing, returns the cudaError_t of the launch (0 on success).
// The library links its own CUDA runtime, whose current device is not the
// caller's, hence `device`.
extern "C" int quantize_launch(const void* x, void* out, long long n, float inv_scale, int dtype,
                               int device, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static thread_local int current = -1;
  if (device != current) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    current = device;
  }
  static int sms[kMaxDevices] = {};
  if (!sms[device]) {
    int count = 0;
    const cudaError_t err =
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    sms[device] = count;
  }
  return (int)(dtype == 0 ? launch<F32>(x, out, n, inv_scale, sms[device], stream)
                          : launch<Bf16>(x, out, n, inv_scale, sms[device], stream));
}

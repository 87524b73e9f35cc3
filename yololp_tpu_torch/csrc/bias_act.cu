// A conv's epilogue in one pass, for sm_90a: out = act(y + b[c]) over a conv
// output y, with c its channel and act none, ReLU or SiLU; and its residual
// form, out = act(y + b[c]) + alpha * x, a BottleRep's second conv and its
// shortcut (x the block's input, alpha its one-element weight).
//
// Replaces no Pallas kernel: XLA fused the bias add and the activation into
// the convolution on the TPU. On the card the deploy convs are cuDNN's, and
// PyTorch gives cuDNN no bias: it runs the conv, then a broadcast add of the
// bias (on a channels_last output, PyTorch's non-vectorized elementwise
// kernel), then the activation as a third pass. This kernel is the add and
// the activation together, one read and one write of y.
//
// The arithmetic is the unfused path's, so the result is its bit for bit:
// float(y) + float(b), rounded to the output type (PyTorch's add), then the
// activation in fp32 on that rounded value, rounded again. ReLU keeps NaN and
// -0 as PyTorch's clamp_min does (v < 0 ? 0 : v); SiLU is v / (1 + expf(-v)),
// the formula of PyTorch's CUDA silu.
//
// The residual form replaces PyTorch's two passes after the epilogue:
// alpha * x (non-vectorized, alpha being a broadcast (1,) tensor) and the
// add, which write alpha * x out, read it back beside the epilogue's output
// and write the sum, 5 passes of x's size where this form reads x once more.
// Its arithmetic is theirs too: t = alpha * x rounded to the output type,
// then a + t rounded, a the epilogue's rounded output. x is read with y's
// 16-byte vectors at y's flat index (it has y's shape and layout), alpha
// from device memory once a thread: the host never reads it, which would
// wait for the stream.
//
// What bounds it on an H100: bytes. 2 bytes read and 2 written an element in
// bf16 (a yololps b128 batch: 2 x 7.70 GB, 4.60 ms at 3.35 TB/s), 2 more
// read in the residual form, a few operations an element. The design is for
// bandwidth:
//
//   1. The tensor is one flat array of N*H*W*C (channels_last; a contiguous
//      NCHW tensor is the case `inner` = H*W below). Each thread moves 16-byte
//      vectors (8 bf16 or 4 fp32), neighbouring threads on neighbouring
//      addresses, in a grid-stride loop over a grid sized to the SMs.
//   2. The channel index is carried along: a thread computes its first
//      vector's channel with one division, then steps it by the stride's
//      remainder, and element by element inside the vector, with no division.
//      Where C is a multiple of the vector (every conv of the backbone and
//      neck) a vector's 8 channels are one aligned 16-byte load of the bias;
//      elsewhere (the head's preds: 277, 12 or 76 channels) each element
//      reads its own. The bias goes through the read-only cache.
//   3. A count that is not a multiple of the vector ends in a scalar tail; a
//      y, x or out whose base is not 16-byte aligned (an offset view) runs
//      the scalar kernel throughout.
//   4. Each form has its own kernels (bias_act_kernel, bias_act_residual_kernel
//      and their scalar ones) over one body: the plain form's code is the
//      body without the residual's loads.
//   5. The host launcher launches on the caller's stream, allocates nothing,
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
  static constexpr int kVec = 4;
  __device__ __forceinline__ static float load(S v) { return v; }
  __device__ __forceinline__ static S store(float v) { return v; }
};

struct Bf16 {
  using S = uint16_t;
  static constexpr int kVec = 8;
  __device__ __forceinline__ static float load(S v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
  __device__ __forceinline__ static S store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

template <class T, int ACT>
__device__ __forceinline__ typename T::S epilogue(typename T::S y, typename T::S b) {
  const typename T::S z = T::store(T::load(y) + T::load(b));
  if (ACT == 0) return z;
  const float v = T::load(z);
  if (ACT == 1) return T::store(v < 0.f ? 0.f : v);
  return T::store(v / (1.0f + expf(-v)));
}

// The place of an element: its run position r in [0, inner) and channel c.
struct Pos {
  long long r;
  int c;
  __device__ __forceinline__ void next(long long inner, int C) {
    if (++r == inner) {
      r = 0;
      if (++c == C) c = 0;
    }
  }
  // advance by a stride whose quotient by inner is dq (as dq % C = dqc) and
  // remainder dr
  __device__ __forceinline__ void advance(long long dr, int dqc, long long inner, int C) {
    r += dr;
    int carry = 0;
    if (r >= inner) {
      r -= inner;
      carry = 1;
    }
    c += dqc + carry;
    if (c >= C) c -= C;
  }
};

__device__ __forceinline__ Pos pos_of(long long e, long long inner, int C) {
  const long long q = e / inner;
  return Pos{e - q * inner, (int)(q % C)};
}

// The residual form's last step on an epilogue output a: a + alpha * x, the
// product rounded to the output type (PyTorch's mul), then the sum (its add).
template <class T>
__device__ __forceinline__ typename T::S residual(typename T::S a, typename T::S x, float alpha) {
  const typename T::S t = T::store(alpha * T::load(x));
  return T::store(T::load(a) + T::load(t));
}

// kBiasVec: inner == 1, C % kVec == 0 and b 16-byte aligned, so a vector's
// channels are c .. c + kVec - 1 and its bias one aligned vector. RES: the
// residual form (x and alpha read); else x and alpha are not touched.
template <class T, int ACT, bool kBiasVec, bool RES>
__device__ __forceinline__ void vector_pass(const typename T::S* __restrict__ y,
                                            const typename T::S* __restrict__ b,
                                            const typename T::S* __restrict__ x,
                                            const typename T::S* __restrict__ alpha,
                                            typename T::S* __restrict__ out, long long n, int C,
                                            long long inner) {
  using S = typename T::S;
  constexpr int V = T::kVec;
  union Pack {
    uint4 u;
    S e[V];
  };
  const float a = RES ? T::load(__ldg(alpha)) : 0.f;
  const long long nvec = n / V;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long span = stride * V;  // elements between a thread's vectors
  const long long dq = span / inner;
  const long long dr = span - dq * inner;
  const int dqc = (int)(dq % C);
  Pos p = pos_of(first * V, inner, C);
  const uint4* y4 = reinterpret_cast<const uint4*>(y);
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  for (long long v = first; v < nvec; v += stride) {
    Pack in, res, sc;
    in.u = __ldcs(y4 + v);  // read once: evict first
    if (RES) sc.u = __ldcs(x4 + v);
    if (kBiasVec) {
      Pack bv;
      bv.u = __ldg(reinterpret_cast<const uint4*>(b + p.c));
#pragma unroll
      for (int i = 0; i < V; ++i) res.e[i] = epilogue<T, ACT>(in.e[i], bv.e[i]);
    } else {
      Pos q = p;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        res.e[i] = epilogue<T, ACT>(in.e[i], __ldg(b + q.c));
        q.next(inner, C);
      }
    }
    if (RES) {
#pragma unroll
      for (int i = 0; i < V; ++i) res.e[i] = residual<T>(res.e[i], sc.e[i], a);
    }
    o4[v] = res.u;
    p.advance(dr, dqc, inner, C);
  }
  const long long tail = nvec * V + first;  // the last n % V elements
  if (tail < n) {
    const Pos t = pos_of(tail, inner, C);
    const S o = epilogue<T, ACT>(y[tail], __ldg(b + t.c));
    out[tail] = RES ? residual<T>(o, x[tail], a) : o;
  }
}

// Any base alignment: one element a thread a step.
template <class T, int ACT, bool RES>
__device__ __forceinline__ void scalar_pass(const typename T::S* __restrict__ y,
                                            const typename T::S* __restrict__ b,
                                            const typename T::S* __restrict__ x,
                                            const typename T::S* __restrict__ alpha,
                                            typename T::S* __restrict__ out, long long n, int C,
                                            long long inner) {
  const float a = RES ? T::load(__ldg(alpha)) : 0.f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n; e += stride) {
    const typename T::S o = epilogue<T, ACT>(y[e], __ldg(b + pos_of(e, inner, C).c));
    out[e] = RES ? residual<T>(o, x[e], a) : o;
  }
}

template <class T, int ACT, bool kBiasVec>
__global__ void __launch_bounds__(kThreads)
    bias_act_kernel(const typename T::S* __restrict__ y, const typename T::S* __restrict__ b,
                    typename T::S* __restrict__ out, long long n, int C, long long inner) {
  vector_pass<T, ACT, kBiasVec, false>(y, b, nullptr, nullptr, out, n, C, inner);
}

template <class T, int ACT>
__global__ void __launch_bounds__(kThreads)
    bias_act_scalar_kernel(const typename T::S* __restrict__ y,
                           const typename T::S* __restrict__ b, typename T::S* __restrict__ out,
                           long long n, int C, long long inner) {
  scalar_pass<T, ACT, false>(y, b, nullptr, nullptr, out, n, C, inner);
}

template <class T, int ACT, bool kBiasVec>
__global__ void __launch_bounds__(kThreads)
    bias_act_residual_kernel(const typename T::S* __restrict__ y,
                             const typename T::S* __restrict__ b,
                             const typename T::S* __restrict__ x,
                             const typename T::S* __restrict__ alpha,
                             typename T::S* __restrict__ out, long long n, int C,
                             long long inner) {
  vector_pass<T, ACT, kBiasVec, true>(y, b, x, alpha, out, n, C, inner);
}

template <class T, int ACT>
__global__ void __launch_bounds__(kThreads)
    bias_act_residual_scalar_kernel(const typename T::S* __restrict__ y,
                                    const typename T::S* __restrict__ b,
                                    const typename T::S* __restrict__ x,
                                    const typename T::S* __restrict__ alpha,
                                    typename T::S* __restrict__ out, long long n, int C,
                                    long long inner) {
  scalar_pass<T, ACT, true>(y, b, x, alpha, out, n, C, inner);
}

// x null: the plain form; else the residual form, x and alpha read
template <class T, int ACT>
cudaError_t launch(const void* y, const void* b, const void* x, const void* alpha, void* out,
                   long long n, int C, long long inner, int sms, cudaStream_t stream) {
  using S = typename T::S;
  const auto* ys = static_cast<const S*>(y);
  const auto* bs = static_cast<const S*>(b);
  const auto* xs = static_cast<const S*>(x);
  const auto* as = static_cast<const S*>(alpha);
  auto* os = static_cast<S*>(out);
  const bool aligned = (reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(out) |
                        reinterpret_cast<uintptr_t>(x)) % 16 == 0;
  const long long work = aligned ? (n / T::kVec > 0 ? n / T::kVec : 1) : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const dim3 grid((unsigned)blocks), block(kThreads);
  const bool bias_vec =
      inner == 1 && C % T::kVec == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (x) {
    if (!aligned) {
      bias_act_residual_scalar_kernel<T, ACT>
          <<<grid, block, 0, stream>>>(ys, bs, xs, as, os, n, C, inner);
    } else if (bias_vec) {
      bias_act_residual_kernel<T, ACT, true>
          <<<grid, block, 0, stream>>>(ys, bs, xs, as, os, n, C, inner);
    } else {
      bias_act_residual_kernel<T, ACT, false>
          <<<grid, block, 0, stream>>>(ys, bs, xs, as, os, n, C, inner);
    }
  } else if (!aligned) {
    bias_act_scalar_kernel<T, ACT><<<grid, block, 0, stream>>>(ys, bs, os, n, C, inner);
  } else if (bias_vec) {
    bias_act_kernel<T, ACT, true><<<grid, block, 0, stream>>>(ys, bs, os, n, C, inner);
  } else {
    bias_act_kernel<T, ACT, false><<<grid, block, 0, stream>>>(ys, bs, os, n, C, inner);
  }
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_act(int act, const void* y, const void* b, const void* x, const void* alpha,
                       void* out, long long n, int C, long long inner, int sms,
                       cudaStream_t stream) {
  switch (act) {
    case 0: return launch<T, 0>(y, b, x, alpha, out, n, C, inner, sms, stream);
    case 1: return launch<T, 1>(y, b, x, alpha, out, n, C, inner, sms, stream);
    case 2: return launch<T, 2>(y, b, x, alpha, out, n, C, inner, sms, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y, out: n elements of `dtype` (0 float32, 1 bfloat16), channel (e / inner) % C
// for element e (inner = 1 for channels_last, H*W for contiguous NCHW); b: C
// elements of the same type; act 0 none, 1 ReLU, 2 SiLU; all on card
// `device`. x and alpha both null: out = act(y + b); else the residual form,
// out = act(y + b) + alpha * x, x n elements laid out as y and alpha one
// element, both of the same type. Launches on `stream`, allocates nothing,
// returns the cudaError_t of the launch (0 on success). The library links its
// own CUDA runtime, whose current device is not the caller's, hence `device`.
extern "C" int bias_act_launch(const void* y, const void* b, const void* x, const void* alpha,
                               void* out, long long n, int C, long long inner, int dtype, int act,
                               int device, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (C <= 0 || inner <= 0 || act < 0 || act > 2 || dtype < 0 || dtype > 1 || !x != !alpha)
    return (int)cudaErrorInvalidValue;
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
  return (int)(dtype == 0 ? launch_act<F32>(act, y, b, x, alpha, out, n, C, inner, sms[device],
                                            stream)
                          : launch_act<Bf16>(act, y, b, x, alpha, out, n, C, inner, sms[device],
                                             stream));
}

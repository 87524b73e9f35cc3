// The yololp_torch custom ops for a process without Python: the schemas of
// yololp_tpu_torch/ops/library.py (the same text, held equal by a test) and
// CUDA kernels for the three ops an exported program calls, greedy_nms_mask,
// int8_conv and bias_act. They launch csrc/greedy_nms.cu, csrc/int8_conv.cu
// and csrc/bias_act.cu through the libraries ops/_build.py builds (their
// extern "C" launchers), with the checks of ops/cuda_nms.py,
// ops/cuda_conv.py and ops/cuda_bias_act.py, on the current stream of the
// tensors' card, and raise on any refusal. matmul, matmul_nt, nms_gate and
// quantize_codes are declared only: no exported program calls the first two,
// and a package that export.compile_aoti writes calls none of nms_gate,
// quantize_codes and bias_act (Inductor fuses them from their plain
// arithmetic there). A package compiled from the .pt2 as it stands calls
// them, and this runner has no nms_gate or quantize_codes.
//
// An AOTInductor package calls a custom op through the dispatcher, so a C++
// process that links this file runs the package's NMS and int8 convs in the
// repository's kernels. Nothing here includes a CUDA header: the stream and
// the device guard come from c10's device-generic interfaces.

#include <ATen/ATen.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/Stream.h>
#include <c10/core/impl/VirtualGuardImpl.h>
#include <torch/library.h>

#include <array>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <optional>
#include <tuple>
#include <vector>

extern "C" {
int greedy_nms_mask_launch(const float* boxes, const float* scores, bool* keep, int B, int K,
                           float thres, int device, void* stream);
int int8_conv_weight_map(const int8_t* w, int O, long long K, long long ldw, void* map_out);
int int8_conv_launch(const int8_t* x, const void* wmap, const float* a, const float* b, void* out,
                     int N, int H, int W, int C, int O, int KH, int stride, int mode, int relu,
                     int device, void* stream);
int bias_act_launch(const void* y, const void* b, const void* x, const void* alpha, void* out,
                    long long n, int C, long long inner, int dtype, int act, int device,
                    void* stream);
}

namespace {

constexpr int64_t kMaxK = 1024;  // greedy_nms.cu's walk holds ceil(K/32) <= 32 words

std::atomic<long long> g_nms_launches{0};
std::atomic<long long> g_conv_launches{0};
std::atomic<long long> g_bias_act_launches{0};

void* current_stream(const at::Tensor& t) {
  c10::impl::VirtualGuardImpl impl(t.device().type());
  return impl.getStream(t.device()).native_handle();
}

at::Tensor greedy_nms_mask_cuda(const at::Tensor& boxes, const at::Tensor& scores,
                                double iou_thres) {
  TORCH_CHECK(boxes.dim() == 3 && boxes.size(2) == 4, "boxes must be (B, K, 4), got ",
              boxes.sizes());
  TORCH_CHECK(scores.dim() == 2 && scores.size(0) == boxes.size(0) &&
                  scores.size(1) == boxes.size(1),
              "scores must be (B, K), got ", scores.sizes());
  TORCH_CHECK(boxes.scalar_type() == at::kFloat && scores.scalar_type() == at::kFloat,
              "boxes and scores must be float32");
  TORCH_CHECK(boxes.device() == scores.device(), "boxes and scores on different devices");
  TORCH_CHECK(boxes.is_contiguous() && scores.is_contiguous(),
              "boxes and scores must be contiguous");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(boxes.data_ptr()) % 16 == 0,
              "boxes must be 16-byte aligned (read as float4)");
  TORCH_CHECK(boxes.size(1) <= kMaxK, "K = ", boxes.size(1), " exceeds the kernel's limit of ",
              kMaxK);
  TORCH_CHECK(boxes.is_cuda(), "the kernel takes cuda tensors");
  const int64_t b = boxes.size(0), k = boxes.size(1);
  at::Tensor keep = at::empty({b, k}, boxes.options().dtype(at::kBool));
  if (b == 0 || k == 0) return keep;
  c10::DeviceGuard guard(boxes.device());  // the launcher sets its device
  const int err = greedy_nms_mask_launch(
      boxes.data_ptr<float>(), scores.data_ptr<float>(), keep.data_ptr<bool>(),
      static_cast<int>(b), static_cast<int>(k), static_cast<float>(iou_thres),
      boxes.device().index(), current_stream(boxes));
  TORCH_CHECK(err == 0, "greedy_nms kernel launch failed: cudaError ", err);
  ++g_nms_launches;
  return keep;
}

int64_t out_size(int64_t h, int64_t kh, int64_t stride) {
  return (h + 2 * (kh / 2) - kh) / stride + 1;
}

// the kernel's output modes, by number: the op's out_mode
constexpr at::ScalarType kModeDtypes[] = {at::kChar, at::kFloat, at::kBFloat16, at::kInt};

// One weight tensor's TMA map: the tensor (so that its memory is not reused
// while the map points at it), the rows the map reads (a copy with rows padded
// to 16 bytes where K % 16 != 0) and the map's 128 bytes. Cached by address,
// shape, version and card, as ops/cuda_conv.py's _WEIGHT_MAPS; the oldest
// dropped past the cap.
struct WeightMap {
  at::Tensor w, rows;
  std::array<unsigned char, 128> map;
};
using MapKey = std::tuple<const void*, std::vector<int64_t>, int64_t, int>;
std::mutex g_maps_mu;
std::map<MapKey, WeightMap> g_maps;
std::deque<MapKey> g_maps_order;
constexpr size_t kMapsCap = 256;

const void* weight_map(const at::Tensor& w_q) {
  const int64_t version = w_q.is_inference() ? -1 : static_cast<int64_t>(w_q._version());
  MapKey key{w_q.data_ptr(), w_q.sizes().vec(), version, w_q.device().index()};
  std::lock_guard<std::mutex> lock(g_maps_mu);
  auto hit = g_maps.find(key);
  if (hit != g_maps.end()) return hit->second.map.data();
  const int64_t o = w_q.size(0);
  at::Tensor rows = w_q.reshape({o, -1});
  const int64_t k = rows.size(1);
  int64_t ld = k;
  if (k % 16 != 0 || reinterpret_cast<uintptr_t>(rows.data_ptr()) % 16 != 0) {
    ld = (k + 15) / 16 * 16;
    at::Tensor buf = at::zeros({o, ld}, rows.options());
    buf.narrow(1, 0, k).copy_(rows);
    rows = buf;
  }
  WeightMap entry{w_q, rows, {}};
  const int err = int8_conv_weight_map(rows.data_ptr<int8_t>(), static_cast<int>(o), k, ld,
                                       entry.map.data());
  TORCH_CHECK(err == 0, "int8_conv weight map failed: error ", err);
  g_maps_order.push_back(key);
  auto& stored = g_maps.emplace(key, std::move(entry)).first->second;
  const void* out = stored.map.data();
  while (g_maps.size() > kMapsCap) {
    g_maps.erase(g_maps_order.front());
    g_maps_order.pop_front();
  }
  return out;
}

at::Tensor int8_conv_cuda(const at::Tensor& x_q, const at::Tensor& w_q, const at::Tensor& a,
                          const at::Tensor& b, int64_t stride, bool relu, int64_t out_mode) {
  TORCH_CHECK(x_q.dim() == 4 && w_q.dim() == 4, "x_q must be (N, H, W, C) and w_q (O, KH, KW, C)");
  const int64_t o = w_q.size(0), kh = w_q.size(1), c = w_q.size(3);
  TORCH_CHECK(kh == w_q.size(2) && (kh == 1 || kh == 3), "only 1x1 and 3x3 kernels");
  TORCH_CHECK(stride == 1 || stride == 2, "stride ", stride, ": only 1 and 2 are supported");
  TORCH_CHECK(x_q.size(3) == c, "x_q has ", x_q.size(3), " channels, w_q ", c);
  TORCH_CHECK(x_q.scalar_type() == at::kChar && w_q.scalar_type() == at::kChar,
              "x_q and w_q must be int8");
  TORCH_CHECK(a.dim() == 1 && a.size(0) == o && b.dim() == 1 && b.size(0) == o &&
                  a.scalar_type() == at::kFloat && b.scalar_type() == at::kFloat,
              "a and b must be float32 of shape (", o, ",)");
  TORCH_CHECK(out_mode >= 0 && out_mode < 4, "out_mode ", out_mode,
              " is not one of 0..3 (int8, float32, bfloat16, int32)");
  const int mode = static_cast<int>(out_mode);
  TORCH_CHECK(x_q.device() == w_q.device() && x_q.device() == a.device() &&
                  x_q.device() == b.device(),
              "tensors on several devices");
  TORCH_CHECK(x_q.is_cuda(), "the kernel takes cuda tensors");
  TORCH_CHECK(x_q.is_contiguous() && w_q.is_contiguous() && a.is_contiguous() &&
                  b.is_contiguous(),
              "x_q, w_q, a and b must be contiguous (x_q NHWC)");
  const int64_t n = x_q.size(0), h = x_q.size(1), w = x_q.size(2);
  at::Tensor out = at::empty({n, out_size(h, kh, stride), out_size(w, kh, stride), o},
                             x_q.options().dtype(kModeDtypes[mode]));
  if (out.numel() == 0) return out;
  const void* wmap = weight_map(w_q);
  c10::DeviceGuard guard(x_q.device());  // the launcher sets its device
  const int err = int8_conv_launch(
      x_q.data_ptr<int8_t>(), wmap, a.data_ptr<float>(), b.data_ptr<float>(), out.data_ptr(),
      static_cast<int>(n), static_cast<int>(h), static_cast<int>(w), static_cast<int>(c),
      static_cast<int>(o), static_cast<int>(kh), static_cast<int>(stride), mode, relu ? 1 : 0,
      x_q.device().index(), current_stream(x_q));
  TORCH_CHECK(err == 0, "int8_conv kernel launch failed: error ", err,
              " (a cudaError_t, or 9999 / 10000 + CUresult from the tensor-map encoder)");
  ++g_conv_launches;
  return out;
}

// With x and alpha, the residual form: act(y + b) + alpha * x
at::Tensor bias_act_cuda(const at::Tensor& y, const at::Tensor& b, int64_t act,
                         const std::optional<at::Tensor>& x,
                         const std::optional<at::Tensor>& alpha) {
  TORCH_CHECK(y.dim() == 4, "y must be a 4-D NCHW tensor, got ", y.sizes());
  TORCH_CHECK((y.scalar_type() == at::kFloat || y.scalar_type() == at::kBFloat16) &&
                  b.scalar_type() == y.scalar_type(),
              "y and b must be float32 or bfloat16 alike");
  TORCH_CHECK(b.dim() == 1 && b.size(0) == y.size(1), "b must be (", y.size(1), ",), got ",
              b.sizes());
  TORCH_CHECK(act >= 0 && act <= 2, "act ", act, " is not one of 0 (none), 1 (ReLU), 2 (SiLU)");
  TORCH_CHECK(y.device() == b.device(), "y and b on different devices");
  TORCH_CHECK(b.is_contiguous(), "b must be contiguous");
  const bool channels_last = y.is_contiguous(at::MemoryFormat::ChannelsLast);
  TORCH_CHECK(channels_last || y.is_contiguous(), "y must be channels_last or contiguous");
  TORCH_CHECK(x.has_value() == alpha.has_value(),
              "the residual form takes x and alpha together");
  if (x.has_value()) {
    TORCH_CHECK(x->scalar_type() == y.scalar_type() && alpha->scalar_type() == y.scalar_type(),
                "x and alpha must be y's dtype");
    TORCH_CHECK(x->sizes() == y.sizes(), "x must have y's shape ", y.sizes(), ", got ",
                x->sizes());
    TORCH_CHECK(x->device() == y.device() && alpha->device() == y.device(),
                "y, x and alpha on different devices");
    TORCH_CHECK(x->is_contiguous(channels_last ? at::MemoryFormat::ChannelsLast
                                               : at::MemoryFormat::Contiguous),
                "x must be laid out as y");
    TORCH_CHECK(alpha->numel() == 1, "alpha must be one element, got ", alpha->sizes());
  }
  TORCH_CHECK(y.is_cuda(), "the kernel takes cuda tensors");
  at::Tensor out = at::empty_like(y);
  if (y.numel() == 0) return out;
  // channel of flat element e: (e / inner) % C
  const int64_t inner = channels_last ? 1 : y.size(2) * y.size(3);
  c10::DeviceGuard guard(y.device());  // the launcher sets its device
  const int err = bias_act_launch(y.data_ptr(), b.data_ptr(),
                                  x.has_value() ? x->data_ptr() : nullptr,
                                  alpha.has_value() ? alpha->data_ptr() : nullptr, out.data_ptr(),
                                  y.numel(), static_cast<int>(y.size(1)), inner,
                                  y.scalar_type() == at::kFloat ? 0 : 1, static_cast<int>(act),
                                  y.device().index(), current_stream(y));
  TORCH_CHECK(err == 0, "bias_act kernel launch failed: cudaError ", err);
  ++g_bias_act_launches;
  return out;
}

}  // namespace

// Launches of each kernel through these ops in this process, for the runner's
// report: 0 greedy_nms, 1 int8_conv, 2 bias_act.
extern "C" long long yololp_ops_launches(int which) {
  return which == 0 ? g_nms_launches.load()
                    : which == 1 ? g_conv_launches.load() : g_bias_act_launches.load();
}

TORCH_LIBRARY(yololp_torch, m) {
  m.def("greedy_nms_mask(Tensor boxes, Tensor scores, float iou_thres) -> Tensor",
        {at::Tag::needs_exact_strides});
  m.def("int8_conv(Tensor x_q, Tensor w_q, Tensor a, Tensor b, int stride, bool relu, "
        "int out_mode) -> Tensor",
        {at::Tag::needs_exact_strides});
  m.def("matmul(Tensor a, Tensor b) -> Tensor", {at::Tag::needs_exact_strides});
  m.def("matmul_nt(Tensor a, Tensor b_t) -> Tensor", {at::Tag::needs_exact_strides});
  m.def("bias_act(Tensor y, Tensor b, int act, Tensor? x=None, Tensor? alpha=None) -> Tensor",
        {at::Tag::needs_exact_strides});
  m.def("nms_gate(Tensor pred, float conf_thres, bool compat_ad4_bug) -> "
        "(Tensor box, Tensor score, Tensor rest, Tensor passed)",
        {at::Tag::needs_exact_strides});
  m.def("quantize_codes(Tensor x, float inv_scale) -> Tensor", {at::Tag::needs_exact_strides});
}

TORCH_LIBRARY_IMPL(yololp_torch, CUDA, m) {
  m.impl("greedy_nms_mask", &greedy_nms_mask_cuda);
  m.impl("int8_conv", &int8_conv_cuda);
  m.impl("bias_act", &bias_act_cuda);
}

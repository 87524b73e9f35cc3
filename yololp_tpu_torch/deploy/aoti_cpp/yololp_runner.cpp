// yololp_runner: native C++ client of an exported YOLO-LP model, no Python.
//
// Counterpart of deploy/pjrt_cpp/yololp_runner.cpp (a PJRT C API client of
// the JAX package's StableHLO artifact) for the PyTorch port: it loads the
// AOTInductor package that yololp_tpu_torch.export writes with aoti=True
// (compiled at export time, so nothing compiles here), runs it on the
// package's device, and links ops.cpp, which runs the package's NMS
// keep-mask and int8 convs in the repository's CUDA kernels.
//
// Build: python -m yololp_tpu_torch.deploy.aoti_cpp   (prints the binary)
// Run:   yololp_runner --model model.aoti.pt2 --bench 20 --batch 32 [--size 640]
//        yololp_runner --model model.aoti.pt2 --image plate.jpg [--size 640]
//                      [--out annotated.jpg]   (only where OpenCV was found)
//
// --bench stages distinct uint8 batches on the device, made by the JAX
// runner's LCG (seed 12345, x = 1664525 x + 1013904223, the byte x >> 24),
// runs one warm-up batch (the first staged one: its `num` is printed), a
// sync loop (each batch's `num` fetched to the host before the next starts)
// and a depth-2 pipelined loop (batch i + 1 enqueued before i's `num` is
// waited for), and prints one `native_bench` JSON line, as the JAX runner.

#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <ATen/ATen.h>
#include <c10/core/Event.h>
#include <c10/core/impl/VirtualGuardImpl.h>

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <optional>
#include <string>
#include <vector>

#if __has_include(<opencv2/core.hpp>)
#define YOLOLP_HAVE_OPENCV 1
#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>
#endif

extern "C" long long yololp_ops_launches(int which);  // ops.cpp

namespace {

struct Args {
  std::string model, image, out;
  int size = 640;
  int batch = 1;
  int bench = 0;  // > 0: timed loops over staged device batches
};

Args ParseArgs(int argc, char** argv) {
  Args a;
  for (int i = 1; i < argc - 1; ++i) {
    std::string k = argv[i];
    if (k == "--model") a.model = argv[++i];
    else if (k == "--image") a.image = argv[++i];
    else if (k == "--out") a.out = argv[++i];
    else if (k == "--size") a.size = std::atoi(argv[++i]);
    else if (k == "--batch") a.batch = std::atoi(argv[++i]);
    else if (k == "--bench") a.bench = std::atoi(argv[++i]);
  }
  if (a.model.empty() || (a.image.empty() && a.bench <= 0) || a.size <= 0 || a.batch <= 0) {
    std::fprintf(stderr,
                 "usage: yololp_runner --model <model.aoti.pt2> --image <jpg> [--size 640] "
                 "[--out out.jpg]\n"
                 "       yololp_runner --model <model.aoti.pt2> --bench <iters> --batch <B> "
                 "[--size 640]  (the package must be exported at batch B and size S)\n");
    std::exit(2);
  }
  return a;
}

// Completion of one batch: its `num` copied to the host behind an event on
// the device's stream (the CPU runs synchronously and needs neither).
struct Inflight {
  std::vector<at::Tensor> outs;
  at::Tensor num_host;
  std::optional<c10::Event> done;
};

class Runner {
 public:
  explicit Runner(const std::string& path) : loader_(path) {
    auto meta = loader_.get_metadata();
    auto it = meta.find("AOTI_DEVICE_KEY");
    device_ = c10::Device(it == meta.end() ? std::string("cpu") : it->second);
  }

  c10::Device device() const { return device_; }

  Inflight Enqueue(const at::Tensor& images) {
    Inflight f;
    f.outs = loader_.run({images});
    if (f.outs.size() < 3) {
      std::fprintf(stderr, "the package returns %zu output(s): an end2end export (det, valid, "
                           "num) is needed; re-export with --end2end\n", f.outs.size());
      std::exit(4);
    }
    const at::Tensor& num = f.outs[2];
    if (device_.is_cpu()) {
      f.num_host = num;
      return f;
    }
    f.num_host = at::empty(num.sizes(), num.options().device(at::kCPU).pinned_memory(true));
    f.num_host.copy_(num, /*non_blocking=*/true);
    c10::impl::VirtualGuardImpl impl(device_.type());
    f.done.emplace(device_.type());
    f.done->record(impl.getStream(device_));
    return f;
  }

  static void Complete(Inflight& f) {
    if (f.done) f.done->synchronize();
  }

 private:
  torch::inductor::AOTIModelPackageLoader loader_;
  c10::Device device_{at::kCPU};
};

int Bench(Runner& runner, const Args& a) {
  const int wanted = 2 * a.bench + 1;
  const int n_staged = std::min(wanted, 48);
  const size_t nbytes = static_cast<size_t>(a.batch) * a.size * a.size * 3;
  std::vector<at::Tensor> staged;
  at::Tensor host = at::empty({a.batch, a.size, a.size, 3}, at::kByte);
  uint8_t* h = host.data_ptr<uint8_t>();
  unsigned seed = 12345;
  for (int s = 0; s < n_staged; ++s) {
    for (size_t i = 0; i < nbytes; ++i) {
      seed = seed * 1664525u + 1013904223u;
      h[i] = static_cast<uint8_t>(seed >> 24);
    }
    staged.push_back(host.to(runner.device(), /*non_blocking=*/false, /*copy=*/true));
  }
  int next = 0;
  auto take = [&]() -> const at::Tensor& { return staged[next++ % n_staged]; };

  Inflight warm = runner.Enqueue(take());  // the first staged batch
  Runner::Complete(warm);
  const at::Tensor first_num = warm.num_host.clone();
  const long long nms0 = yololp_ops_launches(0), conv0 = yololp_ops_launches(1),
                  bias_act0 = yololp_ops_launches(2);

  auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < a.bench; ++i) {
    Inflight f = runner.Enqueue(take());
    Runner::Complete(f);
  }
  auto t1 = std::chrono::steady_clock::now();
  const double sync_s = std::chrono::duration<double>(t1 - t0).count();

  t0 = std::chrono::steady_clock::now();
  Inflight prev = runner.Enqueue(take());
  for (int i = 1; i < a.bench; ++i) {
    Inflight cur = runner.Enqueue(take());
    Runner::Complete(prev);
    prev = std::move(cur);
  }
  Runner::Complete(prev);
  t1 = std::chrono::steady_clock::now();
  const double pipe_s = std::chrono::duration<double>(t1 - t0).count();
  const double batches = 2.0 * a.bench;

  std::string nums;
  const int32_t* nv = first_num.data_ptr<int32_t>();
  for (int64_t i = 0; i < first_num.numel(); ++i)
    nums += (i ? ", " : "") + std::to_string(nv[i]);
  std::printf(
      "{\"native_bench\": {\"batch\": %d, \"size\": %d, \"iters\": %d, \"device\": \"%s\", "
      "\"fresh_buffers\": %s, "
      "\"sync\": {\"total_s\": %.6f, \"ms_per_batch\": %.4f, \"images_per_sec\": %.2f}, "
      "\"pipelined\": {\"total_s\": %.6f, \"ms_per_batch\": %.4f, \"images_per_sec\": %.2f}, "
      "\"ms_per_batch\": %.4f, \"images_per_sec\": %.2f, "
      "\"launches_per_batch\": {\"greedy_nms\": %.2f, \"int8_conv\": %.2f, "
      "\"bias_act\": %.2f}, "
      "\"first_num\": [%s]}}\n",
      a.batch, a.size, a.bench, runner.device().str().c_str(),
      n_staged == wanted ? "true" : "false",
      sync_s, 1e3 * sync_s / a.bench, static_cast<double>(a.batch) * a.bench / sync_s,
      pipe_s, 1e3 * pipe_s / a.bench, static_cast<double>(a.batch) * a.bench / pipe_s,
      1e3 * pipe_s / a.bench, static_cast<double>(a.batch) * a.bench / pipe_s,
      (yololp_ops_launches(0) - nms0) / batches, (yololp_ops_launches(1) - conv0) / batches,
      (yololp_ops_launches(2) - bias_act0) / batches,
      nums.c_str());
  return 0;
}

#ifdef YOLOLP_HAVE_OPENCV
// plate vocabularies (data/vocab.py); province glyphs are UTF-8
const char* kPro[] = {"皖", "沪", "津", "渝", "冀", "晋", "蒙", "辽", "吉",
                      "黑", "苏", "浙", "京", "闽", "赣", "鲁", "豫", "鄂",
                      "湘", "粤", "桂", "琼", "川", "贵", "云", "藏", "陕",
                      "甘", "青", "宁", "新"};
const char* kAlp = "ABCDEFGHJKLMNPQRSTUVWXYZ";
const char* kAds[] = {"A", "B", "C", "D", "E", "F", "G", "H", "J", "K", "L",
                      "M", "N", "P", "Q", "R", "S", "T", "U", "V", "W", "X",
                      "Y", "Z", "0", "1", "2", "3", "4", "5", "6", "7", "8",
                      "9", "警", "学", "O"};

std::string PlateString(const float* det) {
  std::string s = kPro[static_cast<int>(det[20]) % 31];
  s += kAlp[static_cast<int>(det[21]) % 24];
  for (int i = 2; i < 8; ++i) s += kAds[static_cast<int>(det[20 + i]) % 37];
  return s;
}

// letterbox (data/images.py semantics, auto=False square pad)
cv::Mat Letterbox(const cv::Mat& img, int size, float* ratio_out) {
  float r = std::min(size / static_cast<float>(img.rows), size / static_cast<float>(img.cols));
  int new_w = static_cast<int>(std::lround(img.cols * r));
  int new_h = static_cast<int>(std::lround(img.rows * r));
  cv::Mat resized;
  if (new_w != img.cols || new_h != img.rows)
    cv::resize(img, resized, cv::Size(new_w, new_h), 0, 0, cv::INTER_LINEAR);
  else
    resized = img;
  float dw = (size - new_w) / 2.0f, dh = (size - new_h) / 2.0f;
  int top = static_cast<int>(std::lround(dh - 0.1));
  int bottom = static_cast<int>(std::lround(dh + 0.1));
  int left = static_cast<int>(std::lround(dw - 0.1));
  int right = static_cast<int>(std::lround(dw + 0.1));
  cv::Mat out;
  cv::copyMakeBorder(resized, out, top, bottom, left, right, cv::BORDER_CONSTANT,
                     cv::Scalar(114, 114, 114));
  *ratio_out = r;
  return out;
}

int Image(Runner& runner, const Args& a) {
  cv::Mat bgr = cv::imread(a.image);
  if (bgr.empty()) {
    std::fprintf(stderr, "cannot read image %s\n", a.image.c_str());
    return 1;
  }
  float ratio;
  cv::Mat rgb;
  cv::cvtColor(Letterbox(bgr, a.size, &ratio), rgb, cv::COLOR_BGR2RGB);
  at::Tensor input = at::from_blob(rgb.data, {1, a.size, a.size, 3}, at::kByte)
                         .to(runner.device(), /*non_blocking=*/false, /*copy=*/true);
  Inflight f = runner.Enqueue(input);
  Runner::Complete(f);
  at::Tensor det = f.outs[0].cpu().contiguous();
  const int num = f.num_host.data_ptr<int32_t>()[0];
  const float pad_w = (a.size - bgr.cols * ratio) / 2.0f;
  const float pad_h = (a.size - bgr.rows * ratio) / 2.0f;
  std::printf("%d plate(s) detected in %s\n", num, a.image.c_str());
  for (int i = 0; i < num && i < det.size(1); ++i) {
    const float* d = det.data_ptr<float>() + i * 28;
    float conf = 0;
    for (int c = 12; c < 20; ++c) conf += d[c];
    conf /= 8.0f;
    float coords[12];
    for (int c = 0; c < 12; ++c) {
      const float pad = (c % 2 == 0) ? pad_w : pad_h;
      const float lim = (c % 2 == 0) ? bgr.cols : bgr.rows;
      coords[c] = std::min(std::max((d[c] - pad) / ratio, 0.0f), lim);
    }
    std::printf("  %s conf=%.3f box=[%.0f, %.0f, %.0f, %.0f]\n", PlateString(d).c_str(), conf,
                coords[0], coords[1], coords[2], coords[3]);
    if (!a.out.empty()) {
      cv::rectangle(bgr, cv::Point(coords[0], coords[1]), cv::Point(coords[2], coords[3]),
                    cv::Scalar(255, 255, 255), 2);
      for (int k = 0; k < 4; ++k)
        cv::line(bgr, cv::Point(coords[4 + 2 * k], coords[5 + 2 * k]),
                 cv::Point(coords[4 + 2 * ((k + 1) % 4)], coords[5 + 2 * ((k + 1) % 4)]),
                 cv::Scalar(0, 255, 255), 2);
    }
  }
  if (!a.out.empty()) {
    cv::imwrite(a.out, bgr);
    std::printf("annotated image written to %s\n", a.out.c_str());
  }
  return 0;
}
#else
int Image(Runner&, const Args&) {
  std::fprintf(stderr, "--image: this runner was built without OpenCV (no headers were found "
                       "at build time); use --bench, or build where OpenCV is installed\n");
  return 2;
}
#endif

}  // namespace

int main(int argc, char** argv) {
  Args a = ParseArgs(argc, argv);
  Runner runner(a.model);
  std::printf("loaded %s on %s\n", a.model.c_str(), runner.device().str().c_str());
  std::fflush(stdout);
  return a.bench > 0 ? Bench(runner, a) : Image(runner, a);
}

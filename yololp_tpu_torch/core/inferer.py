"""Inference runtime (mirrors yololp_tpu/core/inferer.py:31-230).

The device pipeline: uint8 NHWC batch -> /255 in the compute dtype -> fused
deploy forward (channels_last) -> 290-column decode -> NMS with the greedy
keep-mask in csrc/greedy_nms.cu -> (min(max_det, K), 28) detections. The
host does only decode, letterbox, drawing and text output (cv2 imported
where an image is read, drawn or written). While a profiler records, `_run`
is the span `infer.run` and the H2D copy with the /255 the span
`infer.entry` (utils/profiler.py); the model and the NMS add theirs inside.

`use_int8` swaps the model for its true-int8 plan (quant/int8_infer.py:
calibrated convs in csrc/int8_conv.cu), which then runs inside the same
`_run`, `predict` and spans.

half=True computes in bf16, as the JAX inferer does by default. half=False is
fp32 and turns TF32 off for cuDNN convs and matmuls
(torch.backends.cudnn.allow_tf32 / torch.backends.cuda.matmul.allow_tf32 =
False, process-wide), so that fp32 means fp32.
"""

from __future__ import annotations

import time
from collections import deque
from pathlib import Path
from typing import Mapping, Optional, Union

import numpy as np
import torch

from yololp_tpu_torch.data import vocab as V
from yololp_tpu_torch.data.images import LoadData, check_img_size, letterbox, rescale_dets
from yololp_tpu_torch.layers.fuse import fuse_model
from yololp_tpu_torch.models.yolo import Model, build_model
from yololp_tpu_torch.ops.division import unit_pixels
from yololp_tpu_torch.ops.nms import non_max_suppression
from yololp_tpu_torch.utils.checkpoint import load_inference_variables
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import load_state_dict_strict
from yololp_tpu_torch.utils.device import resolve_device
from yololp_tpu_torch.utils.profiler import annotate


@torch.inference_mode()
def deploy_decode(model, images_u8, device, dtype) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> the (N, A, 290) fp32 decode of the deploy
    `model` on `device`: /255 in `dtype` (as the jitted JAX program divides,
    ops/division.py), then the forward on a channels_last NCHW view."""
    with annotate("infer.entry", device):
        x = torch.as_tensor(images_u8).to(device, non_blocking=True)
        x = unit_pixels(x.permute(0, 3, 1, 2), dtype)
    return model(x)


class CalcFPS:
    """Images per second over the last `nsamples` batches: their images over
    their seconds."""

    def __init__(self, nsamples: int = 50):
        self.batches = deque(maxlen=nsamples)

    def update(self, duration: float, images: int = 1):
        """One batch of `images` that took `duration` seconds."""
        self.batches.append((images, duration))

    def accumulate(self) -> float:
        seconds = sum(d for _, d in self.batches)
        return sum(n for n, _ in self.batches) / seconds if seconds > 0 else 0.0


class Inferer:
    """Single-image / dir / video inference with txt export.

    `weights` is a checkpoint path, a deploy-graph state dict, or None for
    the seeded default init (whose head scores every anchor at the prior).
    """

    def __init__(self, source: str, weights: Optional[Union[str, Mapping]], config,
                 img_size=640, half: bool = True, conf_thres: float = 0.4,
                 iou_thres: float = 0.45, max_det: int = 300,
                 npro: int = V.NPRO, nalp: int = V.NALP, nads: int = V.NADS,
                 nms_selector: str = "topk", device="cuda"):
        self.device = resolve_device(device)
        if isinstance(config, str):
            config = (Config.fromfile(config) if config.endswith(".py")
                      else Config.named(config))
        self.config = config
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        self.nms_selector = nms_selector
        self.dtype = torch.bfloat16 if half else torch.float32
        if not half:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

        if weights:
            model = Model(config, npro=npro, nalp=nalp, nads=nads, deploy=True)
            if not isinstance(weights, Mapping):
                weights = load_inference_variables(weights)
            load_state_dict_strict(model, dict(weights))
        else:
            # weight-free random init (demo/smoke path)
            model = fuse_model(build_model(config, npro, nalp, nads, device="cpu"))
        # the fp32 deploy weights, as the JAX inferer's `variables` (the int8
        # path quantizes its kernels from these)
        self.variables = {k: v.detach().clone() for k, v in model.state_dict().items()}
        self.model = model.to(self.device, self.dtype).to(
            memory_format=torch.channels_last).eval()
        # a multiple of the deepest level's stride: 64 for the P6 heads
        self.img_size = check_img_size(img_size, max(model.detect.strides))
        self.source = source
        self.fps_calc = CalcFPS()

    def use_int8(self, amax_by_path: Mapping[str, float], conv_impl: str = "conv"):
        """Serve in true int8 from now on: `self.model` becomes the int8 plan
        of the deploy model (`int8_infer.int8_model`: kernels quantized per
        output channel from the fp32 `self.variables`, each calibrated conv
        in int8 with the input amax of `amax_by_path`, deploy RepBlocks as
        int8 chains, single-consumer ReLU producers handing int8 codes to
        their consumer; `conv_impl` as `int8_infer.CONV_IMPLS`). `_run`,
        `predict` and their spans are unchanged. A plan that cannot be built
        raises; nothing falls back. Returns self."""
        from yololp_tpu_torch.quant import int8_infer

        self.model = int8_infer.int8_model(self.model, self.variables, dict(amax_by_path),
                                           conv_impl=conv_impl, device=self.device)
        return self

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, images_u8) -> torch.Tensor:
        """(N, H, W, 3) uint8 -> the (N, A, 290) fp32 decode on the device."""
        return deploy_decode(self.model, images_u8, self.device, self.dtype)

    @torch.inference_mode()
    def _run(self, images_u8):
        """(N, H, W, 3) uint8 -> (det, valid, num) on the device."""
        with annotate("infer.run", self.device):
            pred = self.predict(images_u8)
            return non_max_suppression(pred, conf_thres=self.conf_thres,
                                       iou_thres=self.iou_thres, max_det=self.max_det,
                                       candidate_selector=self.nms_selector)

    def warmup(self):
        self._run(np.zeros((1, self.img_size[0], self.img_size[1], 3), np.uint8))
        self._sync()

    def precess_image(self, img_bgr: np.ndarray) -> np.ndarray:
        """BGR source -> letterboxed RGB uint8, full square pad (auto=False)."""
        img = letterbox(img_bgr, self.img_size, auto=False, stride=32)[0]
        return np.ascontiguousarray(img[..., ::-1])  # BGR -> RGB

    def detect_batch(self, imgs_bgr: list) -> list:
        """Letterbox on the host, ONE device call for the whole batch, rescale
        per image."""
        n = len(imgs_bgr)
        batch = np.empty((n, self.img_size[0], self.img_size[1], 3), np.uint8)
        shapes = []
        for i, bgr in enumerate(imgs_bgr):
            batch[i] = self.precess_image(bgr)
            shapes.append(bgr.shape[:2])
        return self._run_batch(batch, shapes)

    def detect_batch_encoded(self, buffers: list) -> list:
        """Batched path from encoded images (jpeg/png/bmp bytes): the native
        batch decoder (data/native.py) decodes and letterboxes the whole batch
        in one call, then one device call and a rescale per image. An
        undecodable buffer keeps its slot. Raises where neither OpenCV nor
        cv2 exists (data/native.py)."""
        from yololp_tpu_torch.data.native import decode_letterbox_batch, require_cv2

        if self.img_size[0] != self.img_size[1]:
            # the native letterbox is square only: decode here and letterbox on
            # the host, keeping each buffer's slot (an undecodable one gets no
            # detections) so that results stay aligned with their files
            cv2 = require_cv2()
            imgs = [cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR) for b in buffers]
            good = [i for i, im in enumerate(imgs) if im is not None]
            dets = self.detect_batch([imgs[i] for i in good]) if good else []
            out = [np.zeros((0, 28), np.float32)] * len(buffers)
            for i, d in zip(good, dets):
                out[i] = d
            return out
        size = self.img_size[0]
        batch, ratios, pads_w, pads_h = decode_letterbox_batch(buffers, size, scaleup=True)
        shapes = [(int(round((size - 2 * pads_h[i]) / ratios[i])),
                   int(round((size - 2 * pads_w[i]) / ratios[i])))
                  for i in range(len(buffers))]
        return self._run_batch(batch, shapes)

    def _run_batch(self, batch: np.ndarray, shapes: list) -> list:
        n = len(batch)
        t0 = time.perf_counter()
        det, valid, num = self._run(batch)
        self._sync()
        self.fps_calc.update(time.perf_counter() - t0, n)
        det = det.float().cpu().numpy()
        valid = valid.cpu().numpy()
        num = num.cpu().numpy()
        out = []
        for i in range(n):
            d = det[i][valid[i]][: int(num[i])]
            if len(d):
                d = rescale_dets(d, (self.img_size[0], self.img_size[1]), shapes[i])
            out.append(d)
        return out

    def detect(self, img_bgr: np.ndarray) -> np.ndarray:
        """Run one image; returns (n, 28) detections in source coordinates."""
        return self._run_batch(self.precess_image(img_bgr)[None], [img_bgr.shape[:2]])[0]

    @staticmethod
    def plate_text(det_row: np.ndarray) -> str:
        ids = det_row[20:28].astype(int)
        return V.plate_string(ids[0], ids[1], ids[2:8])

    def draw(self, img_bgr: np.ndarray, dets: np.ndarray) -> np.ndarray:
        """A copy of `img_bgr` with each detection's box, corner quad and
        plate string with its confidence."""
        import cv2

        from yololp_tpu_torch.data.glyphs import blit_text

        out = img_bgr.copy()
        for d in dets:
            x1, y1, x2, y2 = d[:4].astype(int)
            cv2.rectangle(out, (x1, y1), (x2, y2), (255, 255, 255), 2)
            quad = d[4:12].reshape(4, 2).astype(int)
            for i in range(4):
                cv2.line(out, tuple(quad[i]), tuple(quad[(i + 1) % 4]), (0, 255, 255), 2)
        for d in dets:
            conf = float(d[12:20].mean())
            blit_text(out, f"{self.plate_text(d)} {conf:.2f}",
                      (int(d[0]), max(int(d[1]) - 24, 0)), color=(0, 0, 255), size=22)
        return out

    def _write_labels(self, save_dir: Path, path: str, dets: np.ndarray):
        with open(save_dir / "labels" / (Path(path).stem + ".txt"), "a") as f:
            for d in dets:
                conf = float(d[12:20].mean())
                f.write(" ".join(f"{v:.4f}" for v in d[:12])
                        + f" {conf:.4f} {self.plate_text(d)}\n")

    def infer(self, save_dir: str, save_txt: bool = True, save_img: bool = True,
              view: bool = False):
        """Iterate the source one frame at a time, writing label txts and
        annotated images (a video's frames into <stem>_out.mp4). `view` is
        accepted and unused, as in the JAX package: nothing is shown."""
        import cv2

        save_dir = Path(save_dir)
        (save_dir / "labels").mkdir(parents=True, exist_ok=True)
        vid_writer = None
        results = []
        for img, path, kind in LoadData(self.source):
            dets = self.detect(img)
            results.append((path, dets))
            if save_txt:
                self._write_labels(save_dir, path, dets)
            if save_img:
                drawn = self.draw(img, dets)
                if kind == "image":
                    cv2.imwrite(str(save_dir / Path(path).name), drawn)
                else:
                    if vid_writer is None:
                        vid_writer = cv2.VideoWriter(
                            str(save_dir / (Path(path).stem + "_out.mp4")),
                            cv2.VideoWriter_fourcc(*"mp4v"), 30, (drawn.shape[1], drawn.shape[0]))
                    vid_writer.write(drawn)
        if vid_writer is not None:
            vid_writer.release()
        return results

    def infer_batched(self, save_dir: str, batch_size: int = 16, save_txt: bool = True,
                      save_img: bool = False):
        """Stream the source in fixed-size batches (the tail batch is padded by
        repeating its last item). Still images go as encoded bytes to the
        native batch decoder (detect_batch_encoded), video frames decoded
        (detect_batch); a batch never mixes the two."""
        save_dir = Path(save_dir)
        (save_dir / "labels").mkdir(parents=True, exist_ok=True)
        results = []
        pending, pending_paths = [], []
        pending_encoded = None

        def flush():
            n_real = len(pending)
            batch = pending + [pending[-1]] * (batch_size - n_real)
            detect = self.detect_batch_encoded if pending_encoded else self.detect_batch
            for path, item, d in zip(pending_paths, pending, detect(batch)[:n_real]):
                results.append((path, d))
                if save_txt:
                    self._write_labels(save_dir, path, d)
                if save_img:
                    import cv2

                    bgr = (cv2.imdecode(np.frombuffer(item, np.uint8), cv2.IMREAD_COLOR)
                           if pending_encoded else item)
                    cv2.imwrite(str(save_dir / Path(path).name), self.draw(bgr, d))
            pending.clear()
            pending_paths.clear()

        for item, path, kind in LoadData(self.source, decode_images=False):
            is_encoded = kind == "image_bytes"
            if pending and is_encoded != pending_encoded:
                flush()
            pending_encoded = is_encoded
            pending.append(item)
            pending_paths.append(path)
            if len(pending) == batch_size:
                flush()
        if pending:
            flush()
        return results

"""Inference runtime (mirrors yololp_tpu/core/inferer.py:31-230).

The device pipeline: uint8 NHWC batch -> /255 in the compute dtype -> fused
deploy forward (channels_last) -> 290-column decode -> NMS with the greedy
keep-mask in csrc/greedy_nms.cu -> (min(max_det, K), 28) detections. The
host does only decode, letterbox and text output.

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
from yololp_tpu_torch.ops.nms import non_max_suppression
from yololp_tpu_torch.utils.checkpoint import load_inference_variables
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import load_state_dict_strict
from yololp_tpu_torch.utils.device import resolve_device


class CalcFPS:
    def __init__(self, nsamples: int = 50):
        self.framerate = deque(maxlen=nsamples)

    def update(self, duration: float):
        self.framerate.append(duration)

    def accumulate(self):
        return np.average(self.framerate) if len(self.framerate) > 1 else 0.0


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
        self.img_size = check_img_size(img_size, 32)
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
        self.model = model.to(self.device, self.dtype).to(
            memory_format=torch.channels_last).eval()
        self.source = source
        self.fps_calc = CalcFPS()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def predict(self, images_u8) -> torch.Tensor:
        """(N, H, W, 3) uint8 -> the (N, A, 290) fp32 decode on the device."""
        x = torch.as_tensor(images_u8).to(self.device, non_blocking=True)
        x = x.permute(0, 3, 1, 2).to(self.dtype) / 255.0  # NCHW view, channels_last
        return self.model(x)

    @torch.inference_mode()
    def _run(self, images_u8):
        """(N, H, W, 3) uint8 -> (det, valid, num) on the device."""
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

    def _run_batch(self, batch: np.ndarray, shapes: list) -> list:
        n = len(batch)
        t0 = time.perf_counter()
        det, valid, num = self._run(batch)
        self._sync()
        dt = time.perf_counter() - t0
        for _ in range(n):
            self.fps_calc.update(n / max(dt, 1e-9))
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

    def _write_labels(self, save_dir: Path, path: str, dets: np.ndarray):
        with open(save_dir / "labels" / (Path(path).stem + ".txt"), "a") as f:
            for d in dets:
                conf = float(d[12:20].mean())
                f.write(" ".join(f"{v:.4f}" for v in d[:12])
                        + f" {conf:.4f} {self.plate_text(d)}\n")

    def infer(self, save_dir: str, save_txt: bool = True):
        """Iterate the source one frame at a time, writing label txts."""
        save_dir = Path(save_dir)
        (save_dir / "labels").mkdir(parents=True, exist_ok=True)
        results = []
        for img, path, _ in LoadData(self.source):
            dets = self.detect(img)
            results.append((path, dets))
            if save_txt:
                self._write_labels(save_dir, path, dets)
        return results

    def infer_batched(self, save_dir: str, batch_size: int = 16, save_txt: bool = True):
        """Stream the source in fixed-size batches of decoded frames (the tail
        batch is padded by repeating its last frame)."""
        save_dir = Path(save_dir)
        (save_dir / "labels").mkdir(parents=True, exist_ok=True)
        results = []
        pending, pending_paths = [], []

        def flush():
            n_real = len(pending)
            batch = pending + [pending[-1]] * (batch_size - n_real)
            for path, d in zip(pending_paths, self.detect_batch(batch)[:n_real]):
                results.append((path, d))
                if save_txt:
                    self._write_labels(save_dir, path, d)
            pending.clear()
            pending_paths.clear()

        for img, path, _ in LoadData(self.source):
            pending.append(img)
            pending_paths.append(path)
            if len(pending) == batch_size:
                flush()
        if pending:
            flush()
        return results

"""Validation runtime and the LP corner-and-string accuracy metric (mirrors
yololp_tpu/core/evaler.py).

The metric: each gt is matched to its best-IoU prediction; matches with
IoU >= 0.5 land in one of 10 IoU buckets [0.5, 0.55, ..., 0.95]. A match is
right when the mean L1 error of its 4 corners is below 0.1 * sqrt(gt box
area) and all 8 characters are right. Per-bucket AP = right / matched; the
summary numbers (mAP, mAP50, mAP75, mAP50-95, recall) aggregate the buckets
as the JAX package does. `eval` and `_box_iou` are its numpy, copied.

The device path is the inferer's (core/inferer.py:deploy_decode): uint8 ->
/255 in the model's dtype -> deploy forward (channels_last) -> fp32 NMS with
the greedy keep-mask kernel (csrc/greedy_nms.cu). The tail batch is padded
to batch_size by repeating its last frame, as in the JAX package. With a
mesh the batch is split over one model replica per device
(parallel/infer.py).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from yololp_tpu_torch.core.inferer import deploy_decode
from yololp_tpu_torch.data.datasets import create_dataloader
from yololp_tpu_torch.ops.nms import non_max_suppression
from yololp_tpu_torch.quant.quantize import model_device_dtype
from yololp_tpu_torch.utils.convert import load_state_dict_strict
from yololp_tpu_torch.utils.device import resolve_device


class Evaler:
    def __init__(self, data_dict: Dict, batch_size: int = 32, img_size: int = 640,
                 conf_thres: float = 0.03, iou_thres: float = 0.65,
                 half: bool = True, workers: int = 4, max_det: int = 300,
                 eval_hyp: Optional[Dict] = None, nms_selector: str = "topk",
                 device="cuda"):
        self.data = data_dict
        self.batch_size = batch_size
        self.img_size = img_size
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.half = half
        self.workers = workers
        self.max_det = max_det
        self.nms_selector = nms_selector
        self.eval_hyp = eval_hyp or {}
        self.device = resolve_device(device)
        self.speed_result = np.zeros(4)  # n, pre ms, infer ms, post ms
        self._put, self._devices = None, [self.device]  # a mesh's (make_infer_fn)

    def init_data(self, task: str = "val", rect: bool = False, native: bool = False):
        path = self.data[task if task in self.data else "val"]
        if native and not rect and not self.eval_hyp:
            # the native batch decoder (data/native.py); plain square-letterbox
            # protocol only
            from yololp_tpu_torch.data.datasets import NativeValLoader, TrainValDataset
            from yololp_tpu_torch.data.native import native_available, require_cv2

            if not native_available():
                require_cv2()  # raises where neither OpenCV nor cv2 exists
            dataset = TrainValDataset(path, img_size=self.img_size, augment=False, task="val")
            return NativeValLoader(dataset, self.batch_size, self.img_size), dataset
        if rect:
            # aspect-sorted rect batches, pad 0.5, shapes quantized to 64 px
            from yololp_tpu_torch.data.datasets import RectValLoader, TrainValDataset

            dataset = TrainValDataset(path, img_size=self.img_size, augment=False,
                                      hyp=self.eval_hyp, task="val")
            return RectValLoader(dataset, self.batch_size, self.img_size), dataset
        return create_dataloader(path, self.img_size, self.batch_size, hyp=self.eval_hyp,
                                 augment=False, workers=self.workers, shuffle=False,
                                 drop_last=False, task="val")

    def make_infer_fn(self, model, variables=None, mesh=None):
        """run(images_u8) -> (det, valid, num) on the device. `model` is the
        fused deploy model on this evaler's device, in its compute dtype;
        `variables`, a deploy state dict, is loaded into it first when given
        (a torch model carries its weights, so one function serves every
        eval of a model trained in place).

        With `mesh` (a list of devices, parallel/infer.py:infer_mesh) each
        batch is split over one replica of the model per device (copies of
        the model as it stands now) and staged there by `predict`; the batch
        size must be a multiple of the mesh's size (predict pads every batch
        to it)."""
        self._put, self._devices = None, [self.device]
        if variables is not None:
            load_state_dict_strict(model, {k: v.to(self.device) for k, v in variables.items()})
        dev, dtype = model_device_dtype(model)
        if dev.type != self.device.type:
            raise ValueError(f"the model lies on {dev}, the evaler runs on {self.device}")
        conf, iou, md = self.conf_thres, self.iou_thres, self.max_det
        sel = self.nms_selector
        if mesh is not None:
            if self.batch_size % len(mesh):
                raise ValueError(f"batch_size {self.batch_size} not divisible by mesh size "
                                 f"{len(mesh)}")
            from yololp_tpu_torch.parallel.infer import make_sharded_infer_fn

            run, self._put = make_sharded_infer_fn(model, mesh, conf_thres=conf, iou_thres=iou,
                                                   max_det=md, dtype=dtype,
                                                   candidate_selector=sel)
            self._devices = sorted(set(torch.device(d) for d in mesh), key=str)
            return run

        @torch.inference_mode()
        def run(images_u8):
            pred = deploy_decode(model, images_u8, dev, dtype)
            return non_max_suppression(pred.float(), conf_thres=conf, iou_thres=iou,
                                       max_det=md, candidate_selector=sel)

        return run

    def _sync(self):
        for d in self._devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def predict(self, run_fn, dataloader) -> Tuple[List, List]:
        """Per-image (dets (n, 28), targets (m, 20) in letterboxed pixel
        coordinates, xyxy boxes). Image paths are kept in self.last_paths.
        The speed report's three times are host times around the H2D copy,
        the device program (synchronised) and the D2H copy."""
        pred_results, total_targets = [], []
        self.last_paths = []
        for imgs, labels, masks, paths, _shapes in dataloader:
            bs, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
            if bs < self.batch_size:
                # pad the tail batch so every batch has one shape
                reps = self.batch_size - bs
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], reps, 0)])
            t1 = time.perf_counter()
            imgs = torch.from_numpy(np.ascontiguousarray(imgs))
            # a mesh's run stages its chunks on their cards (make_infer_fn)
            imgs_dev = self._put(imgs) if self._put else imgs.to(self.device)
            self._sync()
            t2 = time.perf_counter()
            det, valid, num = run_fn(imgs_dev)
            self._sync()
            t3 = time.perf_counter()
            det = det.float().cpu().numpy()
            valid = valid.cpu().numpy()
            num = num.cpu().numpy()
            t4 = time.perf_counter()
            self.speed_result += [bs, (t2 - t1) * 1e3, (t3 - t2) * 1e3, (t4 - t3) * 1e3]

            labels, masks = np.asarray(labels), np.asarray(masks)
            for j in range(bs):
                dets_j = det[j][valid[j]][: int(num[j])]
                lbl = labels[j][masks[j] > 0].copy()
                if len(lbl):
                    # normalized cxcywh + corners -> letterboxed-pixel xyxy + corners
                    cx, cy = lbl[:, 8] * w, lbl[:, 9] * h
                    bw, bh = lbl[:, 10] * w, lbl[:, 11] * h
                    out = lbl.copy()
                    out[:, 8] = cx - bw / 2
                    out[:, 9] = cy - bh / 2
                    out[:, 10] = cx + bw / 2
                    out[:, 11] = cy + bh / 2
                    out[:, 12:20:2] = lbl[:, 12:20:2] * w
                    out[:, 13:20:2] = lbl[:, 13:20:2] * h
                    lbl = out
                pred_results.append(dets_j)
                total_targets.append(lbl)
                self.last_paths.append(paths[j])
        return pred_results, total_targets

    @staticmethod
    def _box_iou(a, b):
        """(P, 4) x (T, 4) xyxy IoU."""
        area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
        area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        lt = np.maximum(a[:, None, :2], b[None, :, :2])
        rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[..., 0] * wh[..., 1]
        return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-12)

    def eval(self, preds: List[np.ndarray], targets: List[np.ndarray]):
        """The LP metric: [mAP, mAP50, mAP75, mAP50-95, recall, AP per
        bucket, recall per bucket]; an empty bucket's AP is -1."""
        iou_edges = [0.5 + i * 0.05 for i in range(10)]
        right_cnt = [0] * 10
        cor_right_cnt = [0] * 10
        cls_right_cnt = [0] * 10
        pred_cnts = [0] * 10
        pred_cnt = 0
        true_cnt = 0

        for pred, target in zip(preds, targets):
            true_cnt += len(target)
            if len(pred) == 0 or len(target) == 0:
                continue
            iou = self._box_iou(pred[:, :4], target[:, 8:12])  # (P, T)
            best_iou = iou.max(0)
            best_pred = iou.argmax(0)
            for k in range(len(target)):
                t_iou = best_iou[k]
                if t_iou < 0.5:
                    continue
                if t_iou >= 0.7:
                    pred_cnt += 1
                iou_idx = min(int((t_iou - 0.5) / 0.05), 9)
                t_pred = pred[best_pred[k]]
                t_target = target[k]
                tb = t_target[8:12]
                area = (tb[2] - tb[0]) * (tb[3] - tb[1])

                is_cor = (np.abs(t_pred[4:12] - t_target[12:20]).sum() / 8.0
                          < 0.1 * np.sqrt(max(area, 0.0)))
                is_cls = np.all(t_pred[20:28].astype(int) == t_target[:8].astype(int))
                if is_cor:
                    cor_right_cnt[iou_idx] += 1
                if is_cls:
                    cls_right_cnt[iou_idx] += 1
                if is_cor and is_cls:
                    right_cnt[iou_idx] += 1
                pred_cnts[iou_idx] += 1

        mAP_list = [0.0] * 10
        mAP_50_95 = 0.0
        t_cnt = 0
        right_50 = pred_50 = right_75 = pred_75 = t_right = 0
        for i in range(10):
            mAP_list[i] = (right_cnt[i] / pred_cnts[i] if pred_cnts[i] > 0
                           else -int(right_cnt[i] == pred_cnts[i]))
            if mAP_list[i] != -1:
                mAP_50_95 += mAP_list[i]
                t_cnt += 1
            right_50 += right_cnt[i]
            pred_50 += pred_cnts[i]
            if iou_edges[i] >= 0.75:
                right_75 += right_cnt[i]
                pred_75 += pred_cnts[i]
            if iou_edges[i] >= 0.7:
                t_right += right_cnt[i]
        mAP_50_95 = mAP_50_95 / t_cnt if t_cnt > 0 else 0.0
        mAP_50 = right_50 / pred_50 if pred_50 > 0 else 0.0
        mAP_75 = right_75 / pred_75 if pred_75 > 0 else 0.0
        mAP = t_right / pred_cnt if pred_cnt > 0 else 0.0

        recall_list = [0.0] * 10
        recall = 0
        for i in range(10):
            for j in range(i + 1):
                recall_list[i] += right_cnt[j]
            recall_list[i] = recall_list[i] / true_cnt if true_cnt > 0 else 0.0
            recall += right_cnt[i]
        recall = recall / true_cnt if true_cnt > 0 else 0.0
        return [mAP, mAP_50, mAP_75, mAP_50_95, recall, mAP_list, recall_list]

    def eval_speed(self):
        """Average ms per image: pre (H2D), infer (device), post (D2H)."""
        n = max(self.speed_result[0], 1)
        return {"pre_ms": self.speed_result[1] / n, "infer_ms": self.speed_result[2] / n,
                "post_ms": self.speed_result[3] / n}


def run_eval(model, variables, data_dict, batch_size=32, img_size=640, conf_thres=0.03,
             iou_thres=0.65, half=True, workers=4, eval_hyp=None, task="val", run_fn=None,
             loader=None, evaler=None, return_preds=False, rect=False, native=False,
             mesh=None, nms_selector="topk", device="cuda"):
    """One-call eval (the eval CLI's): returns (results, speed). A prebuilt
    (evaler, loader, run_fn taking (variables, images)) is reused."""
    ev = evaler or Evaler(data_dict, batch_size, img_size, conf_thres, iou_thres, half=half,
                          workers=workers, eval_hyp=eval_hyp, nms_selector=nms_selector,
                          device=device)
    ev.speed_result = np.zeros(4)
    if loader is None:
        loader, _ = ev.init_data(task, rect=rect, native=native)
    if run_fn is None:
        fn = ev.make_infer_fn(model, variables, mesh=mesh)
    else:
        def fn(images):
            return run_fn(variables, images)
    preds, targets = ev.predict(fn, loader)
    results = ev.eval(preds, targets)
    if return_preds:
        return results, ev.eval_speed(), (preds, targets, ev.last_paths)
    return results, ev.eval_speed()

"""Training engine (mirrors yololp_tpu/core/engine.py, the reference's
yolov6/core/engine.py Trainer).

Orchestrates: data loaders (or the device-resident cache) -> the train step
(forward, loss, SGD, EMA: core/train_step.py) -> per-epoch eval of the fused
EMA with the LP metric (core/evaler.py, whose NMS runs csrc/greedy_nms.cu on
the card) -> last/best checkpoints in the JAX package's msgpack format ->
scalar logging (train_log.jsonl, and TensorBoard where it is installed).

RepOpt's second stage (training_mode 'repopt' with a `scales` file: the
RealVGG kernels re-initialized from the hyper-search scales, trained with
gradient masks) and LP distillation from a teacher checkpoint (--distill)
run as in the JAX package.

Data-parallel training: one process per card in a torch.distributed group
(tools/train.py starts or joins it). `batch_size` is the global batch; each
rank loads its shard of the data (`process_shard`, or its block of every
row of the device cache's global index matrix) and the train step computes
the global batch's update (core/train_step.py). Rank 0 alone evaluates (on
a plain copy of the EMA, so it starts no collective), writes checkpoints,
the log, TensorBoard and drawings; a barrier follows every epoch. A
`device_mesh` means this process group and is kept for the JAX
signature's sake.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict, Optional

import numpy as np
import torch

from yololp_tpu_torch.core.evaler import Evaler
from yololp_tpu_torch.core.train_step import init_train_state, make_train_step
from yololp_tpu_torch.data.datasets import create_dataloader
from yololp_tpu_torch.layers.fuse import fuse_state_dict
from yololp_tpu_torch.losses.loss import LossConfig
from yololp_tpu_torch.models.yolo import Model, build_model
from yololp_tpu_torch.parallel.mesh import barrier, broadcast_, is_main_process, rank, world_size
from yololp_tpu_torch.solver.build import SolverConfig
from yololp_tpu_torch.utils.checkpoint import load_checkpoint_raw, save_checkpoint, strip_checkpoint
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import (jax_to_state_dict, load_state_dict_strict,
                                            state_dict_to_jax)
from yololp_tpu_torch.utils.device import resolve_device

LOSS_NAMES = ["iou_loss", "cor_loss", "dfl_loss", "cls_loss",
              "pro_loss", "alp_loss", "ads_loss"]


class _ReplayLoader:
    """Keeps the wrapped loader's batches in host RAM after the first full
    pass and replays them on later evals (the --cache-device runs)."""

    def __init__(self, loader):
        self.loader = loader
        self.cached = None

    def __len__(self):
        return len(self.cached) if self.cached is not None else len(self.loader)

    def __iter__(self):
        if self.cached is not None:
            yield from self.cached
            return
        acc = []
        for batch in self.loader:
            acc.append(batch)
            yield batch
        self.cached = acc


def _vis(what: str, draw):
    """Run a drawing; a failure (no cv2 on this machine, an unreadable
    image) is printed and never stops training, as in the JAX package."""
    try:
        draw()
    except Exception as e:  # noqa: BLE001
        print(f"{what} vis skipped: {e}")


class Trainer:
    def __init__(self, args, cfg: Config, data_dict: Dict, device_mesh=None):
        self.world = world_size()
        self.is_main = is_main_process()
        if device_mesh is not None and len(device_mesh) != self.world:
            raise ValueError(
                f"a mesh of {len(device_mesh)} devices in a process group of {self.world}: "
                "the port runs one process per card (torchrun, or tools.train --data-parallel)")
        self.args = args
        self.cfg = cfg
        self.data_dict = data_dict
        self.device = resolve_device(getattr(args, "device", "cuda"))
        self.img_size = int(args.img_size)
        self.batch_size = int(args.batch_size)
        if self.batch_size % self.world:
            raise ValueError(f"the world size {self.world} must divide the global batch "
                             f"{self.batch_size}")
        host_batch = self.batch_size // self.world
        self.shard = (rank(), self.world) if self.world > 1 else None
        self.epochs = int(args.epochs)
        self.save_dir = args.save_dir
        os.makedirs(osp.join(self.save_dir, "weights"), exist_ok=True)

        self.npro = int(data_dict.get("npro", 31))
        self.nalp = int(data_dict.get("nalp", 24))
        self.nads = int(data_dict.get("nads", 37))
        seed = getattr(args, "seed", 0)

        hyp = dict(cfg["data_aug"])
        self.cache = None
        if getattr(args, "cache_device", False):
            # the dataset staged on the device, batches gathered there by
            # index (data/device_cache.py): the no-augmentation protocol only
            aug_on = [k for k, v in hyp.items()
                      if k != "test_load_size" and float(v or 0) != 0.0]
            if aug_on:
                raise ValueError(f"--cache-device requires all augmentations off, got {aug_on}")
            from yololp_tpu_torch.data.datasets import TrainValDataset
            from yololp_tpu_torch.data.device_cache import DeviceCachedData

            self.train_dataset = TrainValDataset(data_dict["train"], img_size=self.img_size,
                                                 augment=False, task="train")
            self.cache = DeviceCachedData(self.train_dataset, seed=seed, device=self.device)
            self.train_loader = None
            # every rank steps the global batch's schedule
            self.steps_per_epoch = max(self.cache.steps_per_epoch(self.batch_size), 1)
        else:
            self.train_loader, self.train_dataset = create_dataloader(
                data_dict["train"], self.img_size, host_batch, hyp=hyp, augment=True,
                workers=int(args.workers), task="train", seed=seed, process_shard=self.shard)
            self.steps_per_epoch = max(len(self.train_loader), 1)

        self.dtype = torch.bfloat16 if getattr(args, "bf16", True) else torch.float32
        if self.dtype == torch.float32:
            # fp32 means fp32 on the card too (as the inferer's half=False)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = build_model(cfg, self.npro, self.nalp, self.nads, seed=seed,
                                 device=self.device)
        if self.device.type == "cuda":
            self.model = self.model.to(memory_format=torch.channels_last)
        self.state = init_train_state(self.model)

        head = cfg["model"]["head"]
        # Assigner schedule: 'atss' (reference parity), 'tal', or 'atss_tal'
        # (ATSS for atss_warmup_epoch epochs, 0 or absent meaning 4, then TAL)
        assigner = str(getattr(args, "assigner", None) or head.get("assigner", "atss"))
        self.atss_warmup_epoch = (int(head.get("atss_warmup_epoch") or 4)
                                  if assigner == "atss_tal" else 0)
        self.loss_cfg = LossConfig(
            img_size=(self.img_size, self.img_size), strides=tuple(head["strides"]),
            npro=self.npro, nalp=self.nalp, nads=self.nads, use_dfl=bool(head["use_dfl"]),
            reg_max=int(head["reg_max"]), iou_type=head["iou_type"],
            assigner="atss" if assigner == "atss_tal" else assigner,
            approx_topk=bool(getattr(args, "approx_topk", False)))
        self._loss_cfg_formal = (self.loss_cfg._replace(assigner="tal")
                                 if assigner == "atss_tal" else self.loss_cfg)
        solver = cfg["solver"]
        weight_decay = solver["weight_decay"]

        # RepOpt stage 2: re-initialize from the hyper-search scales (the
        # parameters and the EMA), mask the gradients, and scale weight decay
        # by the effective batch (RepOptimizer.get_optimizer_param)
        grad_masks = None
        if cfg.get("training_mode") == "repopt" and cfg.get("scales"):
            from yololp_tpu_torch.solver.repopt import gradient_masks, load_scales, reinitialize

            scales = load_scales(cfg["scales"])
            params = dict(zip(self.state.names, self.state.params))
            new = reinitialize(params, scales, generator=torch.Generator().manual_seed(seed))
            with torch.no_grad():
                for name, p, e in zip(self.state.names, self.state.params, self.state.ema_params):
                    if name in new:
                        p.copy_(new[name])
                        e.copy_(new[name])
            grad_masks = gradient_masks(params, scales)
            accumulate = max(1, round(64 / self.batch_size))
            weight_decay = weight_decay * self.batch_size * accumulate / 64

        self.solver_cfg = SolverConfig(
            lr0=solver["lr0"], lrf=solver["lrf"], momentum=solver["momentum"],
            weight_decay=weight_decay, warmup_epochs=solver["warmup_epochs"],
            warmup_momentum=solver["warmup_momentum"], warmup_bias_lr=solver["warmup_bias_lr"],
            lr_scheduler=solver["lr_scheduler"], epochs=self.epochs,
            steps_per_epoch=self.steps_per_epoch)

        # QAT from a calibration amax json (cfg.qat or --calib-pt)
        quant_amax, quant_skip = None, ("proj_conv",)
        if getattr(args, "quant", False) and not getattr(args, "calib", False):
            from yololp_tpu_torch.quant.quantize import load_amax

            qat_cfg = cfg.get("qat") or {}
            calib_path = getattr(args, "calib_pt", None) or qat_cfg.get("calib_pt")
            if not calib_path:
                raise ValueError("QAT requires a calibration amax file (--calib first)")
            quant_amax = load_amax(calib_path)
            if qat_cfg.get("sensitive_layers_skip"):
                quant_skip = quant_skip + tuple(qat_cfg["sensitive_layers_list"])

        # LP distillation from a teacher checkpoint of either package
        teacher = self._build_teacher() if getattr(args, "distill", False) else None

        def _build_fns(loss_cfg):
            """(step_fn, epoch_fn, multi_epoch_fn) for one assigner config."""
            step_fn = make_train_step(
                self.model, loss_cfg, self.solver_cfg, self.batch_size, quant_amax=quant_amax,
                quant_skip=quant_skip, grad_masks=grad_masks, teacher=teacher,
                distill_cfg=dict(cfg["model"]["head"].get("distill_weight") or {}),
                dtype=self.dtype)
            if self.cache is not None:
                from yololp_tpu_torch.data.device_cache import (make_cached_epoch,
                                                                make_cached_multi_epoch)

                return (None, make_cached_epoch(step_fn, self.cache.img_shape, self.shard),
                        make_cached_multi_epoch(step_fn, self.cache.img_shape, self.shard))
            return step_fn, None, None

        self._build_train_fns = _build_fns
        self._train_fns_cache = {}
        self.step_fn, self.epoch_fn, self.multi_epoch_fn = self._fns_for_epoch(0)
        # DDP took rank 0's parameters and statistics; the EMA follows them
        broadcast_(self.state.ema_params + self.state.ema_stats)

        self.best_ap = -1.0
        self.best_stop_aug_ap = -1.0
        self.log_path = osp.join(self.save_dir, "train_log.jsonl")
        self.tb = self._try_tensorboard() if self.is_main else None

    def _build_teacher(self):
        """The teacher: --teacher-conf (else this run's config) in the train
        graph, with the EMA (else the variables) of --teacher-ckpt."""
        args = self.args
        if not getattr(args, "teacher_ckpt", None):
            raise ValueError("--distill needs --teacher-ckpt")
        name = getattr(args, "teacher_conf", None)
        t_cfg = (self.cfg if not name else
                 Config.fromfile(name) if name.endswith(".py") else Config.named(name))
        ckpt = load_checkpoint_raw(args.teacher_ckpt)
        teacher = Model(t_cfg, npro=self.npro, nalp=self.nalp, nads=self.nads)
        load_state_dict_strict(teacher, jax_to_state_dict(ckpt.get("ema") or ckpt["variables"]))
        teacher = teacher.to(self.device)
        if self.device.type == "cuda":
            teacher = teacher.to(memory_format=torch.channels_last)
        return teacher

    def _fns_for_epoch(self, epoch: int):
        """The step functions of the assigner the schedule gives `epoch`."""
        loss_cfg = (self.loss_cfg if epoch < self.atss_warmup_epoch
                    or self._loss_cfg_formal is self.loss_cfg
                    else self._loss_cfg_formal)
        key = loss_cfg.assigner
        if key not in self._train_fns_cache:
            self._train_fns_cache[key] = self._build_train_fns(loss_cfg)
        return self._train_fns_cache[key]

    def _try_tensorboard(self):
        try:
            from torch.utils.tensorboard import SummaryWriter

            return SummaryWriter(osp.join(self.save_dir, "tb"))
        except (ImportError, OSError):
            return None

    def _log(self, record: Dict):
        with open(self.log_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.tb is not None:
            step = record.get("step", 0)
            for k, v in record.items():
                if isinstance(v, (int, float)) and k != "step":
                    self.tb.add_scalar(k, v, step)

    # ---- checkpoints (the JAX package's layout, engine.py:313-326) ----

    def save(self, name: str, epoch: int):
        st = self.state
        ckpt = {
            "format": "train", "step": int(st.step), "epoch": epoch,
            "variables": state_dict_to_jax(st.state_dict()),
            "ema": state_dict_to_jax(st.ema_state_dict()),
            "opt_state": {"momentum": state_dict_to_jax(dict(zip(st.names, st.momentum)))["params"],
                          "ema_updates": np.asarray(st.ema_updates, np.int32),
                          "last_opt_step": np.asarray(st.last_opt_step, np.int32)},
            "meta": {"cfg": str(self.cfg.get("_filename", "")), "img_size": self.img_size},
        }
        save_checkpoint(ckpt, osp.join(self.save_dir, "weights", name))

    def resume(self, path: str):
        ckpt = load_checkpoint_raw(path)
        v = ckpt["variables"]
        ema = ckpt.get("ema") or v
        opt = ckpt.get("opt_state") or {}
        momentum = (jax_to_state_dict({"params": opt["momentum"]}) if opt.get("momentum")
                    else {})
        self.state.load(jax_to_state_dict(v), jax_to_state_dict(ema), momentum,
                        ema_updates=np.asarray(opt.get("ema_updates", 0)),
                        step=ckpt.get("step", 0),
                        last_opt_step=np.asarray(opt.get("last_opt_step", -1)))
        self.resumed_epoch = int(ckpt.get("epoch", -1))
        return self.resumed_epoch + 1

    # ---- eval hook ----

    def _deploy_variables(self):
        """The EMA folded to the deploy graph's state dict (layers/fuse.py)."""
        with torch.no_grad():
            return fuse_state_dict(self.state.ema_state_dict())

    def _deploy_model(self):
        m = Model(self.cfg, npro=self.npro, nalp=self.nalp, nads=self.nads, deploy=True)
        m = m.to(self.device, self.dtype)
        if self.device.type == "cuda":
            m = m.to(memory_format=torch.channels_last)
        return m.eval()

    def eval_model(self):
        variables = self._deploy_variables()
        if not hasattr(self, "_eval_cache"):
            eval_model = self._deploy_model()
            ev = Evaler(self.data_dict, self.batch_size, self.img_size,
                        workers=int(self.args.workers), device=self.device)
            loader, _ = ev.init_data("val")
            if self.cache is not None:
                # decode the val set once, replay host batches on later evals
                loader = _ReplayLoader(loader)
            # one infer function for every eval: it runs eval_model as it stands
            self._eval_cache = (eval_model, ev, loader, ev.make_infer_fn(eval_model))
        eval_model, ev, loader, run_fn = self._eval_cache
        load_state_dict_strict(eval_model, variables)
        ev.speed_result = np.zeros(4)
        preds, targets = ev.predict(run_fn, loader)
        results = ev.eval(preds, targets)
        self._save_val_vis(preds, ev.last_paths)
        return results, ev.eval_speed()

    def _save_val_vis(self, preds, paths, max_imgs: int = 8):
        """Val predictions with corner quads and plate strings."""
        def draw():
            import cv2

            from yololp_tpu_torch.data.images import letterbox
            from yololp_tpu_torch.utils.visualize import draw_detections, image_grid

            drawn = []
            for path, det in list(zip(paths, preds))[:max_imgs]:
                bgr = cv2.imread(path)
                if bgr is None:
                    continue
                drawn.append(draw_detections(letterbox(bgr, self.img_size, auto=False)[0], det))
            if drawn:
                out = osp.join(self.save_dir, "vis", "val_predictions.jpg")
                os.makedirs(osp.dirname(out), exist_ok=True)
                cv2.imwrite(out, image_grid(drawn))

        _vis("val", draw)

    def _save_train_vis(self, epoch: int, images, labels, masks):
        from yololp_tpu_torch.utils.visualize import save_train_batch_vis

        _vis("train", lambda: save_train_batch_vis(
            images, labels, masks, osp.join(self.save_dir, "vis", f"train_batch_e{epoch}.jpg")))

    # ---- PTQ calibration ----

    def calibrate(self):
        """PTQ calibration of the fused EMA over cfg.ptq.calib_batches train
        batches; writes the per-conv amax json and a calib checkpoint."""
        from yololp_tpu_torch.quant.quantize import calibrate as _calibrate, save_amax

        ptq = self.cfg.get("ptq") or {}
        n_batches = int(ptq.get("calib_batches", 4))
        method = ("max" if ptq.get("calib_method", "max") == "max"
                  else ptq.get("histogram_amax_method", "entropy"))
        skip = ("proj_conv",)
        if ptq.get("sensitive_layers_skip"):
            skip = skip + tuple(ptq.get("sensitive_layers_list", ()))
        deploy = self._deploy_model()
        load_state_dict_strict(deploy, self._deploy_variables())
        batches = []
        for imgs, _, _, _, _ in self.train_loader:
            batches.append(imgs)
            if len(batches) >= n_batches:
                break
        amax = _calibrate(deploy, batches, method=method,
                          percentile=float(ptq.get("histogram_amax_percentile", 99.99)),
                          skip_substrings=skip, device=self.device)
        out = osp.join(self.save_dir, "weights", "calib_amax.json")
        if self.is_main:
            save_amax(amax, out)
            # keep the source epoch: a QAT finetune resuming this checkpoint
            # continues the epoch loop from the source run's position
            self.save("calib_ckpt.msgpack", epoch=getattr(self, "resumed_epoch", -1))
            print(f"PTQ calibration ({method}) over {len(batches)} batches -> {out}")
        barrier()
        return amax

    # ---- main loop ----

    def _run_cached_epoch(self, epoch: int):
        """One epoch over the device-resident dataset; returns (mean loss
        items, steps run)."""
        c = self.cache
        idx_mat = c.epoch_index_matrix(self.batch_size, epoch)
        self._maybe_train_vis(epoch, idx_mat[0])
        self.state, items_sum = self.epoch_fn(self.state, c.images, c.labels, c.masks,
                                              torch.from_numpy(idx_mat))
        return items_sum.cpu().numpy() / max(len(idx_mat), 1), len(idx_mat)

    def _maybe_train_vis(self, epoch: int, idx_row):
        if epoch % 10 == 0 and self.is_main:
            c = self.cache
            self._save_train_vis(epoch, c.host_images[idx_row], c.host_labels[idx_row],
                                 c.host_masks[idx_row])

    def _run_cached_epochs(self, e0: int, k: int):
        """K consecutive epochs in one call (make_cached_multi_epoch): the
        same steps as K _run_cached_epoch calls. Returns [(mean loss items,
        steps)] per epoch."""
        c = self.cache
        mats = np.stack([c.epoch_index_matrix(self.batch_size, e) for e in range(e0, e0 + k)])
        for i in range(k):
            self._maybe_train_vis(e0 + i, mats[i][0])
        self.state, items = self.multi_epoch_fn(self.state, c.images, c.labels, c.masks,
                                                torch.from_numpy(mats))
        items = items.cpu().numpy()
        s = mats.shape[1]
        return [(items[i] / max(s, 1), s) for i in range(k)]

    def train(self, resume_path: Optional[str] = None):
        start_epoch = self.resume(resume_path) if resume_path else 0
        if start_epoch >= self.epochs:
            raise ValueError(
                f"resume epoch {start_epoch} >= --epochs {self.epochs}: the "
                f"training loop would run zero epochs. Pass --epochs greater "
                f"than the resumed checkpoint's epoch (e.g. resumed_epoch + "
                f"finetune_epochs).")
        stop_aug_epoch = self.epochs - int(getattr(self.args, "stop_aug_last_n_epoch", 15))
        eval_interval = int(getattr(self.args, "eval_interval", 20))
        eval_final_n = int(getattr(self.args, "heavy_eval_range", 50))
        epd = max(1, int(getattr(self.args, "epochs_per_dispatch", 1)))

        def _evals_after(j):
            return ((j % eval_interval == 0) or (j >= self.epochs - eval_final_n)
                    or (j == self.epochs - 1))

        def _saves_after(j):
            n_last = int(getattr(self.args, "save_ckpt_on_last_n_epoch", 0) or 0)
            return (getattr(self.args, "save_every_epoch", False)
                    or (n_last and j >= self.epochs - n_last))

        # epoch -> (mean_items, n_steps, wall_s, end_step) for epochs already
        # run inside a multi-epoch chunk
        pending = {}

        for epoch in range(start_epoch, self.epochs):
            if epoch == stop_aug_epoch and self.train_loader is not None:
                self.train_dataset.disable_heavy_aug()
            self.step_fn, self.epoch_fn, self.multi_epoch_fn = self._fns_for_epoch(epoch)
            t0 = time.time()
            epoch_wall = None
            epoch_end_step = None
            if self.cache is not None:
                if epoch in pending:
                    mean_items, n_steps, epoch_wall, epoch_end_step = pending.pop(epoch)
                elif epd > 1:
                    # extend the chunk while no epoch inside it needs an eval,
                    # a per-epoch checkpoint or another assigner; its last
                    # epoch may eval (on the state the chunk returns)
                    k = 1
                    fns0 = self._fns_for_epoch(epoch)
                    while (k < epd and epoch + k < self.epochs
                           and not _evals_after(epoch + k - 1)
                           and not _saves_after(epoch + k - 1)
                           and self._fns_for_epoch(epoch + k) is fns0):
                        k += 1
                    if k == 1:
                        mean_items, n_steps = self._run_cached_epoch(epoch)
                    else:
                        per = self._run_cached_epochs(epoch, k)
                        wall = (time.time() - t0) / k
                        # per-epoch step counts rebuilt from the fixed steps an
                        # epoch, so that the log matches the per-epoch loop
                        end = int(self.state.step)
                        for i, (mi, ns) in enumerate(per):
                            pending[epoch + i] = (mi, ns, wall, end - ns * (k - 1 - i))
                        mean_items, n_steps, epoch_wall, epoch_end_step = pending.pop(epoch)
                else:
                    mean_items, n_steps = self._run_cached_epoch(epoch)
            else:
                items_sum = None  # summed on the device: no host read a step
                n_steps = 0
                for imgs, labels, masks, _, _ in self.train_loader:
                    if n_steps == 0 and epoch % 10 == 0 and self.is_main:
                        self._save_train_vis(epoch, imgs, labels, masks)
                    self.state, total, items = self.step_fn(self.state, imgs, labels, masks)
                    items_sum = items if items_sum is None else items_sum + items
                    n_steps += 1
                mean_items = (items_sum.cpu().numpy() if items_sum is not None
                              else np.zeros(7)) / max(n_steps, 1)
            record = {"epoch": epoch,
                      "step": (epoch_end_step if epoch_end_step is not None
                               else int(self.state.step)),
                      "epoch_time_s": round(epoch_wall if epoch_wall is not None
                                            else time.time() - t0, 1),
                      **{f"train/{k}": float(v) for k, v in zip(LOSS_NAMES, mean_items)}}

            do_eval = ((epoch % eval_interval == 0) or (epoch >= self.epochs - eval_final_n)
                       or (epoch == self.epochs - 1))
            if not self.is_main:
                barrier()  # rank 0 evaluates, checkpoints and logs meanwhile
                continue
            if do_eval:
                results, speed = self.eval_model()
                ap = float(results[0])
                record.update({"val/mAP": ap, "val/mAP50": float(results[1]),
                               "val/mAP75": float(results[2]),
                               "val/mAP50_95": float(results[3]),
                               "val/recall": float(results[4]), **speed})
                self.save("last_ckpt.msgpack", epoch)
                if ap > self.best_ap:
                    self.best_ap = ap
                    self.save("best_ckpt.msgpack", epoch)
                # best within the stop-aug window
                if epoch >= stop_aug_epoch and ap > self.best_stop_aug_ap:
                    self.best_stop_aug_ap = ap
                    self.save("best_stop_aug_ckpt.msgpack", epoch)
            elif epoch == self.epochs - 1 or getattr(self.args, "save_every_epoch", False):
                self.save("last_ckpt.msgpack", epoch)
            if getattr(self.args, "save_ckpt_on_last_n_epoch", 0) and \
                    epoch >= self.epochs - self.args.save_ckpt_on_last_n_epoch:
                self.save(f"{epoch}_ckpt.msgpack", epoch)
            self._log(record)
            print(f"epoch {epoch}: " + " ".join(
                f"{k.split('/')[-1]}={v:.4f}" for k, v in record.items()
                if isinstance(v, float)))
            barrier()

        # end-of-training strip: a final EMA-only, optimizer-free checkpoint
        last = osp.join(self.save_dir, "weights", "last_ckpt.msgpack")
        if self.is_main and osp.isfile(last):
            strip_checkpoint(last, osp.join(self.save_dir, "weights", "final_ckpt.msgpack"))
        barrier()
        return self.best_ap

"""Data-parallel sharded inference and eval over a list of cards
(counterpart of yololp_tpu/parallel/infer.py).

The JAX package shards one program's batch over a 1-D 'data' mesh; every
step is per image (the NMS vmaps over the batch), so XLA splits it with no
collective. Here the mesh is a list of devices and the program is the
inferer's (core/inferer.py:deploy_decode, then ops/nms.py with the greedy
keep-mask kernel): one fused deploy replica per entry, the uint8 batch split
into equal chunks in order, each chunk launched on its own card without a
host synchronisation between cards, the outputs gathered in batch order.
A mesh may name one device twice (two replicas on one card, or on the CPU):
that runs the same path on a machine with one card.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import torch

from yololp_tpu_torch.core.inferer import deploy_decode
from yololp_tpu_torch.ops.nms import non_max_suppression
from yololp_tpu_torch.parallel.mesh import data_sharding
from yololp_tpu_torch.quant.quantize import model_device_dtype
from yololp_tpu_torch.utils.device import resolve_device


def infer_mesh(n_devices: Optional[int] = None, device="cuda") -> Optional[List[torch.device]]:
    """The first `n_devices` cards (all visible ones for None), or None for
    one (the plain path has nothing to split). Raises when fewer than
    `n_devices` are visible. device='cpu' gives `n_devices` CPU replicas."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        n = n_devices or 1
        return [dev] * n if n > 1 else None
    visible = torch.cuda.device_count()
    n = visible if not n_devices else n_devices
    if n > visible:
        raise RuntimeError(f"a mesh of {n} cards needs {n} visible cards, found {visible}")
    return [torch.device("cuda", i) for i in range(n)] if n > 1 else None


def replicate(model: torch.nn.Module, devices: Sequence[torch.device],
              dtype: torch.dtype) -> List[torch.nn.Module]:
    """One eval-mode copy of `model` a device of `devices`, in `dtype`,
    channels_last on a card."""
    replicas = []
    for dev in devices:
        r = copy.deepcopy(model).to(dev, dtype).eval()
        replicas.append(r.to(memory_format=torch.channels_last) if dev.type == "cuda" else r)
    return replicas


def make_sharded_infer_fn(model, mesh: Sequence[torch.device], conf_thres: float = 0.03,
                          iou_thres: float = 0.65, max_det: int = 300, pre_nms_topk: int = 512,
                          dtype: Optional[torch.dtype] = None, candidate_selector: str = "topk"):
    """(run, put) for the fused deploy `model` over `mesh`.

    run(images_u8) -> (det, valid, num) of the whole (B, H, W, 3) batch, in
    batch order, on mesh[0]; B must be a multiple of len(mesh). `images_u8`
    is a host array or tensor, or the chunks `put` staged. put(images_u8)
    copies the chunks to their cards ahead of the call. `dtype` is the
    compute dtype (default: the model's). `run.replicas` holds the replicas
    in mesh order."""
    mesh = [torch.device(d) for d in mesh]
    if not mesh:
        raise ValueError("an empty mesh")
    dtype = dtype or model_device_dtype(model)[1]
    replicas = replicate(model, mesh, dtype)
    put = data_sharding(mesh).put

    @torch.inference_mode()
    def run(images_u8):
        chunks = images_u8 if isinstance(images_u8, list) else put(images_u8)
        outs = []
        for rep, dev, chunk in zip(replicas, mesh, chunks):
            pred = deploy_decode(rep, chunk, dev, dtype)
            outs.append(non_max_suppression(pred.float(), conf_thres=conf_thres,
                                            iou_thres=iou_thres, max_det=max_det,
                                            pre_nms_topk=pre_nms_topk,
                                            candidate_selector=candidate_selector))
        return tuple(torch.cat([o[i].to(mesh[0], non_blocking=True) for o in outs])
                     for i in range(3))

    run.replicas = replicas
    return run, put

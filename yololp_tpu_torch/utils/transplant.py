"""Weight transplant: a flax-layout variable tree -> the reference YOLOv6
torch state dict (copied from yololp_tpu/utils/transplant.py).

The module tree of both packages keeps the reference torch modules' structure
(yolov6/models/yolo.py build_network, yolov6/layers/common.py), so the
mapping is a path rewrite plus layout transforms:

  * conv kernels: HWIO -> OIHW (transpose 3, 2, 0, 1)
  * ConvTranspose kernels: HWIO -> spatial flip -> IOHW (flax's
    conv_transpose does not flip its kernel; torch's, the conv adjoint, does)
  * BatchNorm: scale -> weight, batch_stats mean/var -> running_mean/var
  * the fused head preds split back into the reference's 10 thin 1x1 convs
    (pro/alp/ad0..ad5 from cls_pred{i}; reg/cor from reg_pred{i}), named
    {pro,alp,ad0..ad5,reg,cor}_preds.{i}

The input is the tree a checkpoint holds (numpy arrays, train format), the
one `utils/convert.py:state_dict_to_jax` gives for a port model, so both
packages can be fed the same tree. `build_reference_model` needs the
reference YOLOv6 tree, which is not shipped: its caller names it
(`reference_dir=`, or the YOLOLP_REFERENCE_DIR environment variable).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

# Ordered module-path rewrite rules (applied to the dotted flax path).
_REWRITES = [
    (re.compile(r"\bERBlock_(\d+)_down\b"), r"ERBlock_\1.0"),
    (re.compile(r"\bERBlock_(\d+)_(?:rep|csp)\b"), r"ERBlock_\1.1"),
    (re.compile(r"\bERBlock_(\d+)_sppf\b"), r"ERBlock_\1.2"),
    (re.compile(r"\brbr_dense_conv\b"), "rbr_dense.conv"),
    (re.compile(r"\brbr_dense_bn\b"), "rbr_dense.bn"),
    (re.compile(r"\brbr_1x1_conv\b"), "rbr_1x1.conv"),
    (re.compile(r"\brbr_1x1_bn\b"), "rbr_1x1.bn"),
    (re.compile(r"\brbr_identity_bn\b"), "rbr_identity"),
    (re.compile(r"\bblock_(\d+)\b"), r"block.\1"),
    # head: per-level modules live in ModuleLists in the reference
    (re.compile(r"\bstem(\d+)\b"), r"stems.\1"),
    (re.compile(r"\bcls_conv(\d+)\b"), r"cls_convs.\1"),
    (re.compile(r"\breg_conv(\d+)\b"), r"reg_convs.\1"),
    # RealVGGBlock: the ConvBNAct wrapper 'cell' is flattened in the reference
    (re.compile(r"\.cell\.(conv|bn)\b"), r".\1"),
]

REFERENCE_ENV = "YOLOLP_REFERENCE_DIR"

_HEAD_CLS = re.compile(r"^detect\.cls_pred(\d+)$")
_HEAD_REG = re.compile(r"^detect\.reg_pred(\d+)$")


def _rewrite(path: str) -> str:
    for pat, rep in _REWRITES:
        path = pat.sub(rep, path)
    return path


def _flatten(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _conv_kernel(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr.transpose(3, 2, 0, 1))


def _convtranspose_kernel(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr[::-1, ::-1].transpose(2, 3, 0, 1))


def to_torch_state_dict(variables: Dict[str, Any], npro: int = 31, nalp: int = 24,
                        nads: int = 37, reg_max: int = 16) -> Dict[str, np.ndarray]:
    """Convert train-format flax-layout variables to the reference torch
    state_dict.

    Returns numpy arrays (callers wrap in torch tensors) keyed by the
    reference Model's state_dict keys. num_batches_tracked entries are
    omitted — a freshly constructed reference model already has them at 0,
    and eval never reads them.
    """
    params = variables["params"]
    bstats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}

    for path, arr in _flatten(params):
        mod, leaf = ".".join(path[:-1]), path[-1]

        m = _HEAD_CLS.match(mod)
        if m is not None:
            i = m.group(1)
            names = (["pro_preds", "alp_preds"]
                     + [f"ad{j}_preds" for j in range(6)])
            sizes = [npro, nalp] + [nads] * 6
            off = 0
            for name, size in zip(names, sizes):
                sl = slice(off, off + size)
                if leaf == "kernel":
                    out[f"detect.{name}.{i}.weight"] = _conv_kernel(arr[..., sl])
                else:
                    out[f"detect.{name}.{i}.bias"] = arr[sl].copy()
                off += size
            continue

        m = _HEAD_REG.match(mod)
        if m is not None:
            i = m.group(1)
            nreg = 4 * (reg_max + 1)
            for name, sl in (("reg_preds", slice(0, nreg)),
                             ("cor_preds", slice(nreg, nreg + 8))):
                if leaf == "kernel":
                    out[f"detect.{name}.{i}.weight"] = _conv_kernel(arr[..., sl])
                else:
                    out[f"detect.{name}.{i}.bias"] = arr[sl].copy()
            continue

        tmod = _rewrite(mod)
        if leaf == "kernel":
            if path[-2] == "upsample_transpose":
                out[f"{tmod}.weight"] = _convtranspose_kernel(arr)
            else:
                out[f"{tmod}.weight"] = _conv_kernel(arr)
        elif leaf == "scale":  # BatchNorm gamma
            out[f"{tmod}.weight"] = arr.copy()
        elif leaf in ("bias", "weight", "alpha"):
            out[f"{tmod}.{leaf}"] = arr.copy()
        else:
            raise KeyError(f"unhandled param leaf {mod}.{leaf}")

    for path, arr in _flatten(bstats):
        mod, leaf = _rewrite(".".join(path[:-1])), path[-1]
        if leaf == "mean":
            out[f"{mod}.running_mean"] = arr.copy()
        elif leaf == "var":
            out[f"{mod}.running_var"] = arr.copy()
        else:
            raise KeyError(f"unhandled batch_stats leaf {mod}.{leaf}")

    # the DFL projection constants (the reference's initialize_biases sets
    # them), so that the state_dict is self-contained. The reference's
    # build_network never passes reg_max to Detect, so its proj is always
    # built with the class default 16, also where reg_max is 0 (unused then).
    proj_max = 16
    proj = np.linspace(0, proj_max, proj_max + 1, dtype=np.float32)
    out["detect.proj"] = proj
    out["detect.proj_conv.weight"] = proj.reshape(1, proj_max + 1, 1, 1).copy()
    return out


def resolve_reference_dir(reference_dir: Optional[str] = None) -> str:
    """The reference YOLOv6 tree: `reference_dir`, else $YOLOLP_REFERENCE_DIR.
    There is no implicit default; raises where neither names an existing
    directory."""
    path = reference_dir or os.environ.get(REFERENCE_ENV)
    if not path:
        raise ValueError(f"the reference YOLOv6 tree is needed: pass --reference-dir "
                         f"(reference_dir=) or set {REFERENCE_ENV}")
    if not os.path.isdir(path):
        raise FileNotFoundError(f"reference YOLOv6 tree not found: {path!r}")
    return os.path.abspath(path)


def build_reference_model(config, npro: int = 31, nalp: int = 24, nads: int = 37,
                          reference_dir: Optional[str] = None):
    """Construct the reference torch Model (eval mode, CPU) for a config.

    `config` is this package's DotDict config (attribute access and .get,
    the interface the reference's addict-based Config exposes);
    `reference_dir` as `resolve_reference_dir` takes it.
    """
    import sys
    reference_dir = resolve_reference_dir(reference_dir)
    if reference_dir not in sys.path:
        sys.path.insert(0, reference_dir)
    import torch  # noqa: F401
    from yolov6.models.yolo import Model as TorchModel

    model = TorchModel(config, channels=3, npro=npro, nalp=nalp, nads=nads)
    model.eval()
    return model


def load_into_reference(model, state_dict: Dict[str, np.ndarray]):
    """Load a converted state_dict; assert nothing unexpected is silently
    dropped (missing keys must all be num_batches_tracked)."""
    import torch

    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state_dict.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    bad_missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if bad_missing or unexpected:
        raise ValueError(
            f"transplant mismatch: missing={bad_missing[:8]} unexpected={list(unexpected)[:8]}")
    return model

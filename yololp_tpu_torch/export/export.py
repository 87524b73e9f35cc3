"""Model export: a `torch.export` end-to-end program and an AOTInductor
package for the native runner (mirrors yololp_tpu/export/export.py).

The JAX package exports the fused deploy model as a portable StableHLO
artifact with the weights inlined as constants. The port writes, from one
`torch.export` program at a static (batch, img, img, 3) uint8 input:

  * `<out>.pt2`: the program itself (`torch.export.save`), its weights and
    int8 kernels among its constants, the NMS gate (`nms_gate`), the
    greedy-NMS keep-mask, every int8 conv and every deploy conv's epilogue
    (`bias_act`) as `yololp_torch` custom-op nodes (ops/library.py). Load it
    with `torch.export.load(path).module()`;
  * `<out>.json`: what it takes and returns, with the keys of the JAX
    sidecar; `torch_version` and `device` stand where JAX writes its calling
    convention and platforms;
  * with `aoti=True`, `<out>.aoti.pt2`: an AOTInductor package compiled from
    the same program, which `torch._inductor.aoti_load_package` loads in
    Python and deploy/aoti_cpp/'s runner loads in a C++ process. Its
    `bias_act` and `nms_gate` nodes are first decomposed into their plain
    arithmetic (`inductor_program`), so that Inductor fuses each into the
    passes around it.

Two flavors, as in JAX: 'raw' (uint8 batch -> (B, A, 290) decode) and
'end2end' (-> detections (B, N, 28), valid (B, N), num (B,), with N =
min(max_det, pre_nms_topk)): NMS runs inside the program, so the client does
no post-processing.

PJRT compiles the StableHLO artifact inside the JAX runner, so the JAX
export writes a `.copts` sidecar (compile options for PJRT_Client_Compile).
AOTInductor compiles at export time: that sidecar has no counterpart. The
compile runs with Inductor's `emulate_precision_casts`, so that a fused bf16
pass rounds where eager rounds. TensorFlow's SavedModel (`export_saved_model`)
has no route here and raises.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from yololp_tpu_torch.core.inferer import Inferer
from yololp_tpu_torch.ops import library
from yololp_tpu_torch.ops.division import unit_pixels
from yololp_tpu_torch.ops.nms import non_max_suppression
from yololp_tpu_torch.quant.int8_infer import build_int8_model, quantize_kernels_int8
from yololp_tpu_torch.quant.quantize import load_amax, model_device_dtype

# AOTInductor's options: fused bf16 passes round where eager rounds
AOTI_CONFIGS = {"emulate_precision_casts": True}
OUTPUT_NAMES = ("detections", "valid", "num")


class ExportModel(nn.Module):
    """uint8 NHWC batch -> the (B, A, 290) decode, or with `end2end`
    (det, valid, num): /255 in the model's compute dtype, the fused deploy
    forward (or its int8 copy) on the channels_last NCHW view, then NMS.
    The modules are called directly: `Inferer._run`, `deploy_decode` and
    `make_int8_infer_fn`'s run are wrapped in torch.inference_mode, which
    torch.export should not see."""

    def __init__(self, model: nn.Module, dtype: torch.dtype, end2end: bool = True,
                 conf_thres: float = 0.4, iou_thres: float = 0.45, max_det: int = 300):
        super().__init__()
        self.model, self.dtype, self.end2end = model, dtype, end2end
        self.nms_kw = dict(conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det)

    def decode(self, images_u8: torch.Tensor) -> torch.Tensor:
        return self.model(unit_pixels(images_u8.permute(0, 3, 1, 2), self.dtype))

    def forward(self, images_u8: torch.Tensor):
        pred = self.decode(images_u8)
        if not self.end2end:
            return pred
        return non_max_suppression(pred.float(), **self.nms_kw)


def build_export_fn(model: nn.Module, variables: Mapping[str, torch.Tensor],
                    end2end: bool = True, conf_thres: float = 0.4, iou_thres: float = 0.45,
                    max_det: int = 300, calib_amax: Optional[Dict[str, float]] = None
                    ) -> ExportModel:
    """The program to export, from the fused deploy `model` in its compute
    dtype on its device (`Inferer.model`) and its fp32 deploy state dict
    (`Inferer.variables`). With `calib_amax` (a {module_path: amax} dict
    from calibration) the calibrated convs run in int8 in csrc/int8_conv.cu
    by the JAX `int8_apply`'s default plan (chains, handoffs; the port's
    "conv" plan), the kernels quantized from `variables` and held by the
    program as int8 constants: the artifact is the int8 engine, the
    analogue of the reference's TensorRT int8 build."""
    device, dtype = model_device_dtype(model)
    if calib_amax is not None:
        model = build_int8_model(model, calib_amax, quantize_kernels_int8(variables, device=device))
    return ExportModel(model, dtype, end2end, conf_thres, iou_thres, max_det).eval()


def export_program(module: nn.Module, batch: int, img_size: int,
                   device) -> torch.export.ExportedProgram:
    """`torch.export` of `module` at a static (batch, img, img, 3) uint8
    input on `device`: no dimension is dynamic, as in the JAX export."""
    example = torch.zeros((batch, img_size, img_size, 3), dtype=torch.uint8, device=device)
    with torch.no_grad():
        return torch.export.export(module, (example,))


def openmp_compiler() -> str:
    """The C++ compiler for AOTInductor's build, which links OpenMP
    (-fopenmp): $CXX (Inductor's own choice), else the g++ or c++ on PATH,
    the first that builds an empty program with -fopenmp. A toolchain
    without libgomp fails that build; one machine names such a g++ in
    $CXX."""
    cands = [os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")]
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp, "omp.cpp")
        src.write_text("int main() { return 0; }\n")
        for cxx in dict.fromkeys(c for c in cands if c):
            cmd = [cxx, "-fopenmp", str(src), "-o", str(Path(tmp, "omp"))]
            try:
                if subprocess.run(cmd, capture_output=True).returncode == 0:
                    return cxx
            except OSError:  # not an executable
                continue
    raise RuntimeError(f"no C++ compiler of {cands} builds with -fopenmp, which AOTInductor's "
                       "build needs")


def inductor_program(program: torch.export.ExportedProgram) -> torch.export.ExportedProgram:
    """`program` with the ops whose records say `decompose` (each deploy
    conv's epilogue, `yololp_torch::bias_act`, and the NMS gate,
    `yololp_torch::nms_gate`) written as their plain versions, every other
    node kept. Inductor fuses an op so written into the passes
    around it (the concatenation, max-pool or decode an epilogue feeds, the
    decode the gate reads), which an opaque op prevents: kept as the op, the
    epilogue made a yololps b128 package take 35.5 ms a batch against 24.9 ms
    with Inductor's fusion (an H100 at 700 W)."""
    return program.run_decompositions(library.decompositions())


def compile_aoti(program: torch.export.ExportedProgram, path: str) -> Tuple[str, float]:
    """AOTInductor package of `program` (as `inductor_program` writes it) at
    `path` (a .pt2 name) and the compile's seconds."""
    t0 = time.perf_counter()
    configs = {**AOTI_CONFIGS, "cpp.cxx": (None, openmp_compiler())}
    out = torch._inductor.aoti_compile_and_package(inductor_program(program), package_path=path,
                                                   inductor_configs=configs)
    return out, time.perf_counter() - t0


def output_specs(program: torch.export.ExportedProgram, end2end: bool) -> list:
    """[{name, shape, dtype}] of the program's outputs, read from its graph."""
    out_node = next(n for n in program.graph.nodes if n.op == "output")
    vals = [a.meta["val"] for a in out_node.args[0]]
    names = OUTPUT_NAMES if end2end else ("pred",)
    return [{"name": n, "shape": list(v.shape), "dtype": str(v.dtype).removeprefix("torch.")}
            for n, v in zip(names, vals)]


def export_pt2(config_name_or_path, weights: Optional[Union[str, Mapping]], out_path: str,
               batch: int = 1, img_size: int = 640, end2end: bool = True,
               conf_thres: float = 0.4, iou_thres: float = 0.45, max_det: int = 300,
               half: bool = True, calib_pt: Optional[str] = None, aoti: bool = False,
               device="cuda") -> Dict[str, str]:
    """Export to `<stem>.pt2` + `<stem>.json` (+ `<stem>.aoti.pt2` with
    `aoti`), `<stem>` being `out_path` without a `.pt2` suffix. Returns the
    paths by kind ("pt2", "json", "aoti"). The counterpart of the JAX
    `export_stablehlo`.

    `weights` is a checkpoint path or a deploy state dict, or None for the
    seeded default init, fused. `calib_pt` (an amax json from calibration,
    port- or JAX-written) makes the artifact an int8 engine. The program
    runs on `device` (the card unless the CPU is asked for): its kernels
    are the device's, CUDA's or the plain versions."""
    inferer = Inferer(".", weights, config_name_or_path, img_size=img_size, half=half,
                      device=device)
    module = build_export_fn(inferer.model, inferer.variables, end2end=end2end,
                             conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det,
                             calib_amax=load_amax(calib_pt) if calib_pt else None)
    program = export_program(module, batch, img_size, inferer.device)

    stem = out_path.removesuffix(".pt2")
    os.makedirs(os.path.dirname(os.path.abspath(stem)), exist_ok=True)
    paths = {"pt2": stem + ".pt2", "json": stem + ".json"}
    torch.export.save(program, paths["pt2"])
    meta = {
        "input": {"shape": [batch, img_size, img_size, 3], "dtype": "uint8"},
        "outputs": output_specs(program, end2end),
        "end2end": end2end,
        "int8": calib_pt is not None,
        "conf_thres": conf_thres,
        "iou_thres": iou_thres,
        "max_det": max_det,
        "torch_version": torch.__version__,
        "device": str(inferer.device),
    }
    with open(paths["json"], "w") as f:
        json.dump(meta, f, indent=1)
    if aoti:
        paths["aoti"] = compile_aoti(program, os.path.abspath(stem + ".aoti.pt2"))[0]
    return paths


def export_saved_model(*args, **kwargs):
    """TensorFlow SavedModel export (the JAX package's jax2tf route, its
    analogue of the reference's ONNX/OpenVINO exports). The port has no
    route to it: it needs the `tensorflow` package and a converter from
    PyTorch (through `onnx`), and neither is installed."""
    raise NotImplementedError(
        "saved_model export needs the 'tensorflow' package (and 'onnx' to convert from "
        "PyTorch), which is not installed; export --format pt2 instead")

"""True int8 inference: every calibrated conv runs int8 x int8 -> int32 in
csrc/int8_conv.cu with its dequant or requant epilogue fused, or, with
conv_impl 'dots', as matmuls in csrc/mxu_matmul.cu (mirrors
yololp_tpu/quant/int8_infer.py).

Per-conv inputs are quantized with the calibrated per-tensor amax, kernels
per output channel. Where the JAX package intercepts flax calls, the port
swaps modules on a copy of the fused deploy model: `Int8Conv2d` for each
calibrated `nn.Conv2d`, `Int8RepBlock` for each deploy RepBlock of RepVGG
links whose every link is calibrated. The interceptor's rules are kept: a
conv is swapped only when calibrated, in the weight table and not skipped;
an int8 input is taken as codes at that conv's own scale (the producer
requantized straight to it: a handoff); transposed convs stay float.

The handoff planners are pure functions of path strings, copied from the JAX
package. Unlike the JAX `make_int8_infer_fn`, the port never falls back to
another plan when one fails: it runs the plan it was asked for or raises.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yololp_tpu_torch.layers.blocks import ConvBNAct, LinearAddBlock, RepBlock, RepVGGBlock
from yololp_tpu_torch.ops import cuda_conv, cuda_matmul
from yololp_tpu_torch.ops.nms import non_max_suppression
from yololp_tpu_torch.quant.quantize import (DEFAULT_SKIP_SUBSTRINGS, _skip, check_model_device,
                                             model_device_dtype, module_path)

CONV_IMPLS = ("conv", "dots", "pallas")
_TRANSPOSE_CONV = "upsample_transpose"


def quantize_kernels_int8(state: Mapping[str, torch.Tensor],
                          skip_substrings: Sequence[str] = DEFAULT_SKIP_SUBSTRINGS,
                          device=None) -> Dict[str, Tuple]:
    """Deploy state dict (fp32) -> {module_path: (w_q, w_scale, bias)}.

    w_q is int8 (O, KH, KW, C), the kernel's layout; w_scale (O,) and bias
    (O,) are fp32. Every 4-d kernel is quantized, transposed convs too (as in
    the JAX table; theirs is (out, kH, kW, in) of torch's flipped kernel)."""
    table: Dict[str, Tuple] = {}
    for key, w in state.items():
        if not key.endswith(".weight") or w.dim() != 4:
            continue
        module = key[: -len(".weight")]
        path = module_path(module)
        if _skip(path, skip_substrings):
            continue
        # on the host in fp32, as the JAX package does, then moved: CUDA
        # divides by a Python scalar as a multiply by its reciprocal
        w = w.detach().cpu().float()
        transposed = module.rsplit(".", 1)[-1] == _TRANSPOSE_CONV
        dims, o_axis = ((0, 2, 3), 1) if transposed else ((1, 2, 3), 0)
        scale = torch.clamp(w.abs().amax(dim=dims), min=1e-9) / 127.0
        shape = [1, 1, 1, 1]
        shape[o_axis] = -1
        w_q = torch.round(w / scale.reshape(shape)).clamp(-128, 127).to(torch.int8)
        w_q = w_q.permute(1, 2, 3, 0) if transposed else w_q.permute(0, 2, 3, 1)
        bias = state.get(module + ".bias")
        bias = torch.zeros_like(scale) if bias is None else bias.detach().cpu().float()
        table[path] = tuple(t.contiguous().to(device) for t in (w_q, scale, bias))
    return table


# ---------------- handoff planners (copied from the JAX package) ----------------


def backbone_handoffs(amax_by_path: Dict[str, float], weight_table: Dict[str, Tuple],
                      skip_substrings: Sequence[str] = DEFAULT_SKIP_SUBSTRINGS
                      ) -> Dict[str, str]:
    """{producer_conv_path: consumer_conv_path} for the single-consumer
    backbone stage seams (stem -> ERBlock_2_down, {stage}_down -> the first
    conv of {stage}_rep), where both ends are calibrated and unskipped."""
    pairs = [("stem/conv", "ERBlock_2_down/conv")]
    for s in ("ERBlock_2", "ERBlock_3", "ERBlock_4", "ERBlock_5", "ERBlock_6"):
        pairs.append((f"{s}_down/conv", f"{s}_rep/conv1/conv"))
    out: Dict[str, str] = {}
    for prod_sfx, cons_sfx in pairs:
        for prod in [p for p in amax_by_path if p.endswith(prod_sfx)]:
            cons = prod[: -len(prod_sfx)] + cons_sfx
            if all(p in amax_by_path and p in weight_table and not _skip(p, skip_substrings)
                   for p in (prod, cons)):
                out[prod] = cons
    return out


def _unique_suffix(paths, suffix):
    cands = [p for p in paths if p.endswith(suffix)]
    return cands[0] if len(cands) == 1 else None


def graph_handoffs(amax_by_path: Dict[str, float], weight_table: Dict[str, Tuple],
                   skip_substrings: Sequence[str] = DEFAULT_SKIP_SUBSTRINGS,
                   relu_acts: bool = True) -> Dict[str, str]:
    """The backbone seams plus the SPPF / CSP-SPPF internals, the SPPF exit
    -> neck reduce_layer0 and BiFusion cv2 -> downsample: every seam whose
    producer is ReLU (folded into the requant clip), whose path to the
    consumer is monotone and scale-preserving, and whose output has that one
    conv consumer (yololp_tpu/quant/int8_infer.py:graph_handoffs)."""
    out = backbone_handoffs(amax_by_path, weight_table, skip_substrings)
    paths = list(amax_by_path)

    def ok(*ps):
        return all(p is not None and p in amax_by_path and p in weight_table
                   and not _skip(p, skip_substrings) for p in ps)

    for p in paths:
        if "Bifusion" in p and p.endswith("/cv2/conv"):
            cons = p[: -len("cv2/conv")] + "downsample/conv"
            if ok(p, cons):
                out[p] = cons

    if not relu_acts:
        return out

    red0 = _unique_suffix(paths, "neck/reduce_layer0/conv")
    for p in paths:
        if not p.endswith("/cv1/conv") or "_sppf/" not in p:
            continue
        base = p[: -len("cv1/conv")]
        if (base + "cv7/conv") in amax_by_path:
            spine = [("cv1", "cv3"), ("cv3", "cv4"), ("cv4", "cv5"),
                     ("cv5", "cv6"), ("cv6", "cv7"), ("cv2", "cv7")]
            for a, b in spine:
                prod, cons = base + f"{a}/conv", base + f"{b}/conv"
                if ok(prod, cons):
                    out[prod] = cons
            if ok(base + "cv7/conv", red0):
                out[base + "cv7/conv"] = red0
        else:
            if ok(p, base + "cv2/conv"):
                out[p] = base + "cv2/conv"
            if ok(base + "cv2/conv", red0):
                out[base + "cv2/conv"] = red0
    return out


def chain_exit_handoffs(amax_by_path: Dict[str, float], weight_table: Dict[str, Tuple],
                        skip_substrings: Sequence[str] = DEFAULT_SKIP_SUBSTRINGS
                        ) -> Dict[str, str]:
    """{repblock_module_path: consumer_conv_path} for deploy RepBlock chains
    whose exit has exactly one conv consumer: ERBlock_{5,6}_rep -> a plain
    SPPF's cv1 (not a CSP-SPPF, where cv1 and cv2 share the input),
    Rep_p4 -> reduce_layer1 (or the P6 neck's seams) and the last bottom-up
    RepBlock -> the deepest head stem."""
    paths = list(amax_by_path)
    out: Dict[str, str] = {}

    def ok(p):
        return (p is not None and p in amax_by_path and p in weight_table
                and not _skip(p, skip_substrings))

    for p in paths:
        for st in ("ERBlock_5", "ERBlock_6"):
            sfx = f"{st}_rep/conv1/conv"
            if p.endswith(sfx):
                rb = p[: -len("/conv1/conv")]
                sppf = rb[: -len(f"{st}_rep")] + f"{st}_sppf/"
                if (sppf + "cv7/conv") in amax_by_path:
                    continue
                cons = sppf + "cv1/conv"
                if ok(cons):
                    out[rb] = cons

    def add(rb_sfx, cons_sfx):
        rbp = _unique_suffix(paths, rb_sfx + "/conv1/conv")
        cons = _unique_suffix(paths, cons_sfx)
        if rbp is not None and ok(cons):
            out[rbp[: -len("/conv1/conv")]] = cons

    if any(p.endswith("Rep_p5/conv1/conv") for p in paths):   # P6 neck
        add("neck/Rep_p5", "neck/reduce_layer1/conv")
        add("neck/Rep_p4", "neck/reduce_layer2/conv")
        add("neck/Rep_n6", "detect/stem3/conv")
    else:
        add("neck/Rep_p4", "neck/reduce_layer1/conv")
        add("neck/Rep_n4", "detect/stem2/conv")
    return out


# ---------------- execution ----------------


def conv3x3_as_dots(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 same-padding conv(int8, int8) -> int32, NHWC, as 9
    shifted (N*H*W, C) @ (C, O) matmuls in csrc/mxu_matmul.cu, the int32
    partials summed by plain adds (yololp_tpu/quant/int8_infer.py:226).
    x (N, H, W, C) int8, w_hwio (3, 3, C, O) int8. Each tap's weights go to
    the kernel as the K-major (O, C) view w[:, dy, dx, :] of the (O, 3, 3, C)
    weights, rows 9C apart: no copy when w_hwio is the permuted view of
    contiguous (O, 3, 3, C) weights, as the int8 modules pass them. Equal to
    the conv: the integer sums are exact in any order."""
    n, h, w, c = x.shape
    w_q = w_hwio.permute(3, 0, 1, 2)
    if w_q.stride(-1) != 1:
        w_q = w_q.contiguous()
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + h, dx:dx + w, :].contiguous().reshape(n * h * w, c)
            y = cuda_matmul.matmul_nt(tap, w_q[:, dy, dx, :])
            acc = y if acc is None else acc + y
    return acc.reshape(n, h, w, -1)


def _int8_conv(a_q, w_q, stride: int, padding: int, conv_impl: str = "conv") -> torch.Tensor:
    """conv(int8, int8) -> int32 accumulator, NHWC, w_q (O, KH, KW, C).
    conv_impl 'dots' takes 3x3/s1/p1 through `conv3x3_as_dots` and 1x1/s1
    through one matmul (yololp_tpu/quant/int8_infer.py:248-264); every other
    geometry, and the other conv_impls, take int8_conv.cu's accumulator mode.
    The accumulator does not depend on the route: integer sums are exact."""
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl {conv_impl!r} is not one of {CONV_IMPLS}")
    o, kh = w_q.shape[:2]
    if padding != kh // 2:
        raise ValueError(f"padding {padding}: the kernel pads k // 2")
    if conv_impl == "dots" and stride == 1:
        if kh == 3:
            return conv3x3_as_dots(a_q, w_q.permute(1, 2, 3, 0))
        n, h, w, c = a_q.shape
        y = cuda_matmul.matmul_nt(a_q.reshape(n * h * w, c), w_q.reshape(o, c))
        return y.reshape(n, h, w, o)
    zeros = torch.zeros(o, dtype=torch.float32, device=w_q.device)
    return cuda_conv.int8_conv(a_q, w_q, zeros, zeros, stride, False, torch.int32)


def _dots_chain(x: torch.Tensor, entry_inv_scale: float, links) -> torch.Tensor:
    """cuda_conv.run_chain with each link's conv as matmuls: the int32
    accumulator by `conv3x3_as_dots`, then the kernel's epilogue in plain
    PyTorch (cuda_conv.epilogue_plain, equal to the fused one bit for bit)."""
    q = x.contiguous() if x.dtype == torch.int8 else cuda_conv.quantize_codes(x, entry_inv_scale)
    for w_q, a, b, dt in links:
        q = cuda_conv.epilogue_plain(_int8_conv(q, w_q, 1, 1, "dots"), a, b, True, dt)
    return q


def _run_links(x, entry_inv_scale, links, conv_impl: str):
    """A chain's links on NHWC `x`, by the route conv_impl names."""
    if conv_impl == "dots":
        return _dots_chain(x, entry_inv_scale, links)
    return cuda_conv.run_chain(x, entry_inv_scale, links)


def _chain_repblock(x, sub_paths, amax_by_path, weight_table, out_dtype=None,
                    conv_impl: str = "conv", exit_amax=None):
    """A deploy RepBlock (a chain of biased 3x3 conv + ReLU links), NHWC, in
    int8: quantize at entry (an int8 `x` is taken as codes at the first
    link's scale), int8 -> int8 links with relu folded into the clip, and a
    float exit with relu, or, with `exit_amax` (a single-consumer exit),
    int8 codes at the consumer's scale."""
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl {conv_impl!r} is not one of {CONV_IMPLS}")
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    return _run_links(x, *cuda_conv.chain_links(sub_paths, amax_by_path, weight_table,
                                                out_dtype, exit_amax), conv_impl)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last in the port) -> a contiguous NHWC tensor, a view
    when `x` is channels_last."""
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(y: torch.Tensor) -> torch.Tensor:
    """NHWC -> the NCHW view with channels_last strides, no copy."""
    return y.permute(0, 3, 1, 2)


class Int8Conv2d(nn.Module):
    """A calibrated conv in int8: quantize the input (unless it arrives as
    int8 codes at this conv's scale), run the kernel, and write either int8
    codes at the consumer's scale (a handoff, relu folded into the clip) or
    the dequantized float output (the module's activation follows). With
    conv_impl 'dots' the accumulator comes from `_int8_conv(..., 'dots')`
    and the same epilogue runs in plain PyTorch."""

    def __init__(self, conv: nn.Conv2d, amax: float, entry: Tuple, model_dtype,
                 handoff_amax=None, conv_impl: str = "conv"):
        super().__init__()
        kh, kw = conv.kernel_size
        if (conv.groups != 1 or kh != kw or kh not in (1, 3) or conv.dilation != (1, 1)
                or conv.padding != (kh // 2, kh // 2) or conv.stride[0] != conv.stride[1]
                or conv.stride[0] not in (1, 2)):
            raise NotImplementedError(
                f"int8 conv of geometry k={conv.kernel_size} s={conv.stride} "
                f"p={conv.padding} g={conv.groups} is not supported by the kernel")
        w_q, w_scale, bias = entry
        dev = w_q.device
        self.stride = conv.stride[0]
        self.model_dtype = model_dtype
        self.conv_impl = conv_impl
        self.handoff = handoff_amax is not None
        # epilogue constants on the host in fp32 (cuda_conv.host_scale)
        x_scale, w_scale, bias = cuda_conv.host_scale(amax), w_scale.cpu(), bias.cpu()
        if self.handoff:
            s_next = cuda_conv.host_scale(handoff_amax)
            a, b = x_scale * w_scale / s_next, bias / s_next
        else:
            a, b = x_scale * w_scale, bias
        self.register_buffer("w_q", w_q)
        # the input quantize multiplies by fp32(1 / x_scale), as jax.jit does
        self.x_inv_scale = cuda_conv.inv_host_scale(amax)
        self.register_buffer("a", a.contiguous().to(dev))
        self.register_buffer("b", b.contiguous().to(dev))

    def out_dtype(self, x: torch.Tensor) -> torch.dtype:
        """int8 codes for a handoff; else the input's float dtype, or the
        model's for an int8 input."""
        if self.handoff:
            return torch.int8
        return self.model_dtype if x.dtype == torch.int8 else x.dtype

    def forward(self, x):
        a_q = x if x.dtype == torch.int8 else cuda_conv.quantize_codes(x, self.x_inv_scale)
        if self.conv_impl == "dots":
            acc = _int8_conv(_nhwc(a_q), self.w_q, self.stride, self.w_q.shape[1] // 2, "dots")
            y = cuda_conv.epilogue_plain(acc, self.a, self.b, self.handoff, self.out_dtype(x))
        else:
            y = cuda_conv.int8_conv(_nhwc(a_q), self.w_q, self.a, self.b, self.stride,
                                    self.handoff, self.out_dtype(x))
        return _nchw(y)


class Int8Handoff(nn.Module):
    """A deploy RepVGG (or LinearAdd) block whose conv hands int8 codes off:
    its ReLU is folded into the requant clip, so the block is the conv
    alone."""

    def __init__(self, conv: Int8Conv2d):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        return self.conv(x)


class Int8RepBlock(nn.Module):
    """A deploy RepBlock of RepVGG links run as one int8 chain. With
    conv_impl 'pallas' on a square map it takes the fused plan
    (`chain_repblock_fused`, float exit); otherwise `_chain_repblock`'s plan,
    with the chain-exit handoff when the plan has one, its links as matmuls
    with conv_impl 'dots'."""

    def __init__(self, sub_paths, amax_by_path, weight_table, model_dtype, conv_impl,
                 exit_amax=None):
        super().__init__()
        self.sub_paths = list(sub_paths)
        self.conv_impl = conv_impl
        self.exit_amax = exit_amax
        # both plans' links, epilogue constants computed once
        args = (self.sub_paths, amax_by_path, weight_table, model_dtype)
        self.fused = cuda_conv.chain_links(*args)
        self.plan = cuda_conv.chain_links(*args, exit_amax=exit_amax)

    def links_for(self, x: torch.Tensor):
        """(entry scale, links) of the plan NCHW `x` takes: the fused plan
        only on a square map (the JAX package's rule)."""
        square = x.shape[2] == x.shape[3]
        return self.fused if self.conv_impl == "pallas" and square else self.plan

    def forward(self, x):
        return _nchw(_run_links(_nhwc(x), *self.links_for(x), self.conv_impl))


def _is_deploy_repvgg_chain(m: nn.Module) -> bool:
    """A deploy RepBlock of RepVGG links (a BepC3's RepBlock of BottleReps,
    or one of RealVGG or LinearAdd links, runs conv by conv, as in JAX)."""
    return all(type(b) is RepVGGBlock and b.deploy for b in m.links())


def _set(root: nn.Module, dotted: str, module: nn.Module):
    parent, _, name = dotted.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, name, module)


def build_int8_model(model: nn.Module, amax_by_path: Dict[str, float],
                     weight_table: Dict[str, Tuple],
                     skip_substrings: Sequence[str] = DEFAULT_SKIP_SUBSTRINGS,
                     chain_repblocks: bool = True, stage_handoffs: bool = True,
                     conv_impl: str = "conv") -> nn.Module:
    """A copy of the fused deploy `model` with its calibrated convs swapped
    for int8 modules, by the plan the arguments select (int8_apply's)."""
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl {conv_impl!r} is not one of {CONV_IMPLS}")
    if not getattr(model, "deploy", False):
        raise ValueError("int8 execution needs the fused deploy model (layers/fuse.py)")
    out = copy.deepcopy(model).eval()
    device, model_dtype = model_device_dtype(out)
    table = {p: tuple(t.to(device) for t in e) for p, e in weight_table.items()}
    cfg = getattr(model, "config", None)
    relu_acts = (cfg.get("training_mode", "repvgg") if hasattr(cfg, "get")
                 else "repvgg") != "conv_silu"
    handoffs = (graph_handoffs(amax_by_path, table, skip_substrings, relu_acts=relu_acts)
                if stage_handoffs else {})
    chain_exits = (chain_exit_handoffs(amax_by_path, table, skip_substrings)
                   if (stage_handoffs and chain_repblocks) else {})

    def usable(p):
        return p in amax_by_path and p in table and not _skip(p, skip_substrings)

    if chain_repblocks:
        for name, m in list(out.named_modules()):
            if not (isinstance(m, RepBlock) and _is_deploy_repvgg_chain(m)):
                continue
            path = module_path(name)
            sub = [f"{path}/conv1/conv"] + [f"{path}/block_{i}/conv" for i in range(m.n - 1)]
            if all(usable(p) for p in sub):
                cons = chain_exits.get(path)
                _set(out, name, Int8RepBlock(
                    sub, amax_by_path, table, model_dtype, conv_impl,
                    exit_amax=float(amax_by_path[cons]) if cons is not None else None))

    for name, m in list(out.named_modules()):
        path = module_path(name)
        if not (type(m) is nn.Conv2d and usable(path)):
            continue
        cons = handoffs.get(path)
        conv = Int8Conv2d(m, float(amax_by_path[path]), table[path], model_dtype,
                          handoff_amax=float(amax_by_path[cons]) if cons is not None else None,
                          conv_impl=conv_impl)
        parent_name = name.rpartition(".")[0]
        parent = out.get_submodule(parent_name)
        if cons is None:
            _set(out, name, conv)
        elif isinstance(parent, (RepVGGBlock, LinearAddBlock)) and parent.deploy:
            _set(out, parent_name, Int8Handoff(conv))
        elif isinstance(parent, ConvBNAct) and isinstance(parent.act, nn.ReLU):
            _set(out, name, conv)
            parent.act = nn.Identity()  # ReLU is folded into the requant clip
        else:
            raise ValueError(f"handoff from {path}: its activation is not a ReLU "
                             "that the requant clip can fold")
    return out


@torch.inference_mode()
def int8_apply(model: nn.Module, x: torch.Tensor, amax_by_path: Dict[str, float],
               weight_table: Dict[str, Tuple],
               skip_substrings: Sequence[str] = DEFAULT_SKIP_SUBSTRINGS,
               chain_repblocks: bool = True, stage_handoffs: bool = True,
               conv_impl: str = "conv"):
    """Forward of the fused deploy `model` on NCHW `x` with calibrated convs
    in int8: deploy RepBlocks as int8 chains (chain_repblocks), and, with
    stage_handoffs, the graph's single-consumer ReLU producers and chain
    exits requantizing straight to their consumer's scale."""
    int8_model = build_int8_model(model, amax_by_path, weight_table, skip_substrings,
                                  chain_repblocks, stage_handoffs, conv_impl)
    return int8_model(x)


def int8_model(model: nn.Module, state: Mapping[str, torch.Tensor],
               amax_by_path: Dict[str, float],
               skip_substrings: Sequence[str] = DEFAULT_SKIP_SUBSTRINGS,
               chain_repblocks: bool = True, stage_handoffs: bool = True,
               conv_impl: str = "conv", device=None) -> nn.Module:
    """The int8 plan of the fused deploy `model` (in its compute dtype), its
    kernels quantized per output channel from `state`, its fp32 deploy state
    dict (as in the JAX package): `build_int8_model`'s copy, built once. It
    is what `Inferer.use_int8` serves; a plan that cannot be built raises."""
    table = quantize_kernels_int8(state, skip_substrings, device=device)
    return build_int8_model(model, amax_by_path, table, skip_substrings,
                            chain_repblocks=chain_repblocks, stage_handoffs=stage_handoffs,
                            conv_impl=conv_impl)


def make_int8_infer_fn(model: nn.Module, state: Mapping[str, torch.Tensor],
                       amax_by_path: Dict[str, float],
                       skip_substrings: Sequence[str] = DEFAULT_SKIP_SUBSTRINGS,
                       with_nms: bool = True, conf_thres: float = 0.4,
                       iou_thres: float = 0.45, max_det: int = 300,
                       candidate_selector: str = "topk", conv_impl: str = "conv",
                       stage_handoffs: bool = True, device="cuda"):
    """uint8 NHWC batch -> detections (det, valid, num) with calibrated convs
    in int8, for callers that take a bare function: the plan `Inferer.use_int8`
    serves (`int8_model`), run by the inferer's entry (`deploy_decode`) and
    NMS, so that its outputs are `Inferer._run`'s bit for bit. `model` is the
    fused deploy model in its compute dtype, `state` its fp32 deploy state
    dict. The plan is built once; a failure raises and nothing falls back."""
    from yololp_tpu_torch.core.inferer import deploy_decode

    dev = check_model_device(model, device)
    int8 = int8_model(model, state, amax_by_path, skip_substrings,
                      stage_handoffs=stage_handoffs, conv_impl=conv_impl, device=dev)
    dtype = model_device_dtype(int8)[1]

    @torch.inference_mode()
    def run(images_u8):
        pred = deploy_decode(int8, images_u8, dev, dtype)
        if not with_nms:
            return pred
        return non_max_suppression(pred, conf_thres=conf_thres, iou_thres=iou_thres,
                                   max_det=max_det, candidate_selector=candidate_selector)

    run.int8_model = int8  # the swapped model, for inspection
    return run

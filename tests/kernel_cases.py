"""The card cases of every op of yololp_tpu_torch/ops/library.py, and the
evaler's card check.

`OPS[name]` holds, for the op of that name: `cases()`, {case: make(dev)},
each giving the op's arguments on `dev`; `check(args, got, what)`, which
raises unless the kernel's output `got` equals the plain version's on
`args` (bit for bit, but for the matmul's bf16 products, held within
2 K 2**-24 (|a| @ |b|) elementwise, and SiLU's epilogue, within
EPILOGUE_SILU_ULPS); `refusals`, [(make(dev), exception, match)] of what
the kernel does not take; and `empty(dev)`, arguments whose output is
empty (or, for a matmul, whose reduction is), which launch nothing.

tests/test_torch_cuda.py runs every case of every op on the card;
chip_smoke.py's timing and integration phases take their operands here.
Imports no JAX (the machine with the card has none).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

MAIN_BATCH = 32  # the main path's batch (chip_smoke.py's BATCH)
SEED = 0

# ---------------- greedy_nms_mask (csrc/greedy_nms.cu) ----------------


def clustered_boxes(rng, n, n_clusters=8, scale=640.0):
    """Overlapping clusters of xyxy boxes (the generator of tests/test_nms.py)."""
    centers = rng.uniform(50, scale - 50, size=(n_clusters, 2))
    idx = rng.integers(0, n_clusters, size=n)
    cxy = centers[idx] + rng.normal(0, 12, size=(n, 2))
    wh = rng.uniform(20, 80, size=(n, 2))
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)


def chain_boxes(n):
    """Box i overlaps only box i + 1 (IoU 1/4): greedy keeps every other box
    at iou_thres 0.2."""
    xs = np.arange(n, dtype=np.float32) * 6.0
    return np.stack([xs, np.zeros(n, np.float32), xs + 10.0, np.full(n, 10.0, np.float32)], -1)


def mask_cases(rng):
    """name -> (boxes (B, K, 4), score-sorted scores (B, K), iou_thres):
    clustered boxes at the main path's B = 32, K = 512, a conf-gated zero
    tail, exact score ties, degenerate boxes, a 128-deep chain, K = 1024,
    B = 1 and 128, K = 1, 300 and 1000, every score 0, and a 512-deep chain
    that crosses every band of rows (and every block of the kernel's
    cluster)."""
    def scores(b, k, g=rng):
        return np.sort(g.uniform(0.01, 1.0, (b, k)).astype(np.float32), -1)[:, ::-1].copy()

    boxes = np.stack([clustered_boxes(rng, 512) for _ in range(MAIN_BATCH)])
    gated = scores(MAIN_BATCH, 512)
    gated[:, 300:] = 0.0
    tied = scores(MAIN_BATCH, 512)
    tied[:, 50:250] = tied[:, 50:51]
    flipped = boxes.copy()
    flipped[:, ::3] = flipped[:, ::3][..., [2, 3, 0, 1]]
    cases = {
        "clustered_B32_K512": (boxes, scores(MAIN_BATCH, 512), 0.45),
        "conf_gated_zero_tail": (boxes, gated, 0.45),
        "exact_score_ties": (boxes, tied, 0.45),
        "degenerate_boxes": (flipped, scores(MAIN_BATCH, 512), 0.45),
        "chain_128_deep": (np.stack([chain_boxes(128)] * 4),
                           np.tile(np.linspace(1, 0.5, 128, dtype=np.float32), (4, 1)), 0.2),
        "clustered_K1024": (np.stack([clustered_boxes(rng, 1024) for _ in range(8)]), scores(8, 1024), 0.45),
    }
    # the cases added with the cluster design draw from a generator of their
    # own, so `rng` sees the draws it saw before
    more = np.random.default_rng(SEED + 1)
    k300 = scores(4, 300, more)
    k300[:, 200:] = 0.0
    k1 = scores(MAIN_BATCH, 1, more)
    k1[::2] = 0.0
    cases.update({
        "B1_K512": (boxes[:1].copy(), scores(1, 512, more), 0.45),
        "B128_K512": (np.stack([clustered_boxes(more, 512) for _ in range(128)]),
                      scores(128, 512, more), 0.45),
        "K1": (boxes[:, :1].copy(), k1, 0.45),
        "K300_zero_tail": (np.stack([clustered_boxes(more, 300) for _ in range(4)]), k300, 0.45),
        "K1000": (np.stack([clustered_boxes(more, 1000) for _ in range(8)]), scores(8, 1000, more), 0.45),
        "all_scores_zero": (boxes, np.zeros((MAIN_BATCH, 512), np.float32), 0.45),
        "chain_512_every_band": (np.stack([chain_boxes(512)] * 4),
                                 np.tile(np.linspace(1, 0.5, 512, dtype=np.float32), (4, 1)), 0.2),
    })
    return cases


def _nms_case(name):
    def make(dev):
        boxes, scores, thr = mask_cases(np.random.default_rng(1))[name]
        return torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev), thr
    return make


def _nms_check(args, keep, what):
    """The keep-mask equal to the plain version's on the CPU."""
    from yololp_tpu_torch.ops.cuda_nms import greedy_nms_mask_plain

    boxes, scores, thr = args
    want = greedy_nms_mask_plain(boxes.cpu(), scores.cpu(), thr)
    if not torch.equal(keep.cpu(), want):
        raise AssertionError(f"greedy_nms kernel != plain [{what}]: "
                             f"{int((keep.cpu() != want).sum())} slots differ")


# ---------------- int8_conv (csrc/int8_conv.cu) ----------------

# yololps at 640: (RepBlock, S, C = O, links) of every deploy chain
CHAINS = [("backbone/ERBlock_2_rep", 160, 64, 2), ("backbone/ERBlock_3_rep", 80, 128, 4),
          ("backbone/ERBlock_4_rep", 40, 256, 6), ("backbone/ERBlock_5_rep", 20, 512, 2),
          ("neck/Rep_p4", 40, 128, 4), ("neck/Rep_p3", 80, 64, 4),
          ("neck/Rep_n3", 40, 128, 4), ("neck/Rep_n4", 20, 256, 4)]


def int8_specs():
    """name -> (N, H, C, O, K, stride, relu, out_dtype, extreme codes): every
    RepBlock chain geometry of yololps at 640 with N = 32 (int8 out with
    relu, then bf16 and fp32 exits), a 3x3/s2, 1x1 with O = 277 and 12, an
    int8 out without relu, entry codes at -128 and 127, the accumulator
    mode, C = 32 (K = 288, not a multiple of the 128-byte stage) with M not
    a multiple of the 128-row tile, a 3x3/s2 fp32 exit without relu at
    O = 12, and a C that takes the byte-gather path."""
    specs = {}
    for s, c in sorted({(s, c) for _, s, c, _ in CHAINS}, reverse=True):
        for dt in (torch.int8, torch.bfloat16, torch.float32):
            specs[f"chain_S{s}_C{c}_{str(dt)[6:]}"] = (MAIN_BATCH, s, c, c, 3, 1, True, dt, False)
    specs["3x3_s2_160to80_C64_O128"] = (MAIN_BATCH, 160, 64, 128, 3, 2, True, torch.int8, False)
    specs["1x1_O277_bf16"] = (MAIN_BATCH, 80, 64, 277, 1, 1, False, torch.bfloat16, False)
    specs["1x1_O12_bf16"] = (MAIN_BATCH, 80, 64, 12, 1, 1, False, torch.bfloat16, False)
    specs["int8_no_relu"] = (MAIN_BATCH, 40, 128, 128, 3, 1, False, torch.int8, False)
    specs["extreme_codes"] = (4, 40, 128, 128, 3, 1, True, torch.int8, True)
    specs["accumulator_int32"] = (4, 40, 128, 64, 3, 1, False, torch.int32, True)
    specs["C32_K288_M4107_O48"] = (3, 37, 32, 48, 3, 1, True, torch.int8, True)
    specs["3x3_s2_C32_O12_fp32_no_relu"] = (2, 37, 32, 12, 3, 2, False, torch.float32, False)
    specs["C24_byte_gather"] = (4, 33, 24, 40, 3, 2, True, torch.int8, False)
    return specs


def int8_case(rng, spec):
    """(x (N, H, W, C) int8, w (O, K, K, C) int8, a, b, stride, relu,
    out_dtype) on the host, for one spec of int8_specs()."""
    n, h, c, o, k, stride, relu, dt, extremes = spec
    x = rng.integers(-128, 128, (n, h, h, c)).astype(np.int8)
    if extremes:
        x.reshape(-1)[::7] = -128
        x.reshape(-1)[3::7] = 127
    w = rng.integers(-128, 128, (o, k, k, c)).astype(np.int8)
    # scales as a calibrated link has them: codes land across [-128, 127]
    a = (rng.uniform(0.5, 2.0, o) * 127.0 / (3.0 * 128 * 128 * np.sqrt(k * k * c))).astype(np.float32)
    b = rng.normal(0, 8, o).astype(np.float32)
    return x, w, a, b, stride, relu, dt


def _int8_case(name):
    def make(dev):
        from yololp_tpu_torch.ops.cuda_conv import out_mode

        x, w, a, b, stride, relu, dt = int8_case(np.random.default_rng(2), int8_specs()[name])
        return (*[torch.from_numpy(t).to(dev) for t in (x, w, a, b)], stride, relu, out_mode(dt))
    return make


def _int8_check(args, got, what):
    """The output equal to the plain version's on the same (card) tensors."""
    from yololp_tpu_torch.ops.cuda_conv import int8_conv_plain, mode_dtype

    *tensors, stride, relu, mode = args
    want = int8_conv_plain(*tensors, stride, relu, mode_dtype(mode))
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"int8_conv kernel != plain [{what}]: {tuple(got.shape)} "
                             f"{got.dtype} vs {tuple(want.shape)} {want.dtype}, "
                             f"{int((got != want).sum()) if got.shape == want.shape else '-'} "
                             f"of {want.numel()} differ")


# ---------------- matmul, matmul_nt (csrc/mxu_matmul.cu) ----------------

# the matmul probe's shapes (M, K, N) (tools/probe_mxu_int8.py)
MM_PROBE = [(16384, 512, 512), (8192, 1024, 1024), (4096, 2048, 2048)]


def matmul_cases():
    """name -> (M, K, N, layout): the probe's shapes, ragged ones (K not a
    multiple of 16 bytes, N odd or above 64 by a little, M not a multiple of
    the 128-row tile), K = 288 (a C = 32 conv's), one conv9dots tap of an
    80x80, C = O = 128 map at N = 32 (layout "kn": `matmul(a, b)` with b
    (K, N)), and the same tap as the dots plan passes it (layout "tap":
    `matmul_nt(a, w[:, 1, 2, :])` of (N, 3, 3, K) weights, rows 9K apart)."""
    cases = {f"probe_{m}x{k}x{n}": (m, k, n, "kn") for m, k, n in MM_PROBE}
    cases.update({"ragged_1000x24x12": (1000, 24, 12, "kn"),
                  "ragged_4097x2048x277": (4097, 2048, 277, "kn"),
                  "ragged_333x37x65": (333, 37, 65, "kn"),
                  "K288_4097x288x64": (4097, 288, 64, "kn"),
                  f"conv9dots_tap_N{MAIN_BATCH}_80x80_C128": (MAIN_BATCH * 80 * 80, 128, 128, "kn"),
                  f"strided_tap_view_N{MAIN_BATCH}_80x80_C128": (MAIN_BATCH * 80 * 80, 128, 128, "tap"),
                  "strided_tap_view_O12_C64": (5000, 64, 12, "tap")})
    return cases


# layout -> the shape of the tensor b is (a view of): "kn" b (K, N) for
# `matmul`; "nt" b_t (N, K) and "tap" one tap's (N, K) view of (N, 3, 3, K)
# weights, for `matmul_nt`
_B_SHAPES = {"kn": lambda k, n: (k, n), "nt": lambda k, n: (n, k), "tap": lambda k, n: (n, 3, 3, k)}


def matmul_operands(rng, m, k, n, dtype, layout="kn", dev="cpu"):
    """(a (M, K), b) on `dev`: b (K, N), (N, K) for layout "nt", or for
    layout "tap" the strided (N, K) view of one tap of (N, 3, 3, K) weights
    (sliced on `dev`: a copy of a strided view would be contiguous). int8
    codes over [-128, 127], or bf16 values ~N(0, 1)."""
    if dtype == torch.int8:
        a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-128, 128, _B_SHAPES[layout](k, n)).astype(np.int8))
    else:
        a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).bfloat16()
        b = torch.from_numpy(rng.standard_normal(_B_SHAPES[layout](k, n), dtype=np.float32)).bfloat16()
    a, b = a.to(dev), b.to(dev)
    return a, (b[:, 1, 2, :] if layout == "tap" else b)


def matmul_error(a, b, got, what):
    """max |kernel - plain| of `got` = a @ b, b (K, N): int8 equal, bf16
    within 2 K 2**-24 (|a| @ |b|) elementwise (both sum exact fp32 products
    in fp32, in other orders); raises beyond."""
    from yololp_tpu_torch.ops.cuda_matmul import matmul_plain

    want = matmul_plain(a, b)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"mxu_matmul [{what}]: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    diff = (got.double() - want.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if a.dtype == torch.int8:
        if not torch.equal(got, want):
            raise AssertionError(f"mxu_matmul kernel != plain [{what}]: max |diff| {err}, "
                                 f"{int((got != want).sum())} of {got.numel()} differ")
        return err
    bound = 2 * a.shape[1] * 2.0 ** -24 * (a.double().abs() @ b.double().abs())
    if not bool((diff <= bound).all()):
        raise AssertionError(f"mxu_matmul bf16 [{what}]: {int((diff > bound).sum())} of "
                             f"{diff.numel()} beyond 2K 2^-24 (|a|@|b|), max |diff| {err}")
    return err


_MM_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16}


def _mm_cases(nt):
    def make_case(m, k, n, layout, dtype):
        return lambda dev: matmul_operands(np.random.default_rng(3), m, k, n, dtype, layout, dev)
    return {f"{name}_{d}": make_case(*spec, dt) for name, spec in matmul_cases().items()
            if (spec[3] != "kn") == nt for d, dt in _MM_DTYPES.items()}


# ---------------- bias_act (csrc/bias_act.cu) ----------------

# the distinct (C, stride, act) of the bias_act calls of one deploy forward
# of the benchmark cells' P5 models, 21 of yololps' 71 and 28 of yolov6m's
# 108 (tests/test_torch_bias_act.py holds them to the models)
EPILOGUE_SHAPES = {
    "yololps": [(12, 8, 0), (12, 16, 0), (12, 32, 0), (32, 2, 1), (64, 4, 1), (64, 8, 0),
                (64, 8, 1), (64, 8, 2), (64, 16, 1), (128, 8, 1), (128, 16, 0), (128, 16, 1),
                (128, 16, 2), (128, 32, 1), (256, 16, 1), (256, 32, 1), (256, 32, 2),
                (277, 8, 0), (277, 16, 0), (277, 32, 0), (512, 32, 1)],
    "yolov6m": [(48, 2, 1), (64, 4, 1), (64, 8, 1), (76, 8, 0), (76, 16, 0), (76, 32, 0),
                (96, 4, 1), (96, 8, 0), (96, 8, 1), (96, 8, 2), (96, 16, 1), (128, 8, 1),
                (128, 16, 1), (192, 8, 1), (192, 16, 0), (192, 16, 1), (192, 16, 2),
                (192, 32, 1), (256, 16, 1), (256, 32, 1), (277, 8, 0), (277, 16, 0),
                (277, 32, 0), (384, 16, 1), (384, 32, 1), (384, 32, 2), (512, 32, 1),
                (768, 32, 1)]}
EPILOGUE_IMG, EPILOGUE_BATCH = 640, 128
# the distinct (C, stride, act) of the residual form's calls (a shortcut
# BottleRep's second conv) of one deploy forward: 7 of yolov6m's 24 at 640,
# 8 of yolov6l6's 60 at 1280 (tests/test_torch_bias_act.py holds them to the
# models)
RESIDUAL_SHAPES = {
    "yolov6m": [(64, 4, 1), (64, 8, 1), (128, 8, 1), (128, 16, 1), (256, 16, 1), (256, 32, 1),
                (512, 32, 1)],
    "yolov6l6": [(64, 4, 2), (64, 8, 2), (128, 8, 2), (128, 16, 2), (256, 16, 2), (256, 32, 2),
                 (384, 32, 2), (512, 64, 2)]}
RESIDUAL_IMG = {"yolov6m": 640, "yolov6l6": 1280}
# SiLU's allowance against PyTorch's silu and the plain version, in ulps of
# the dtype: the kernel uses the same formula, v / (1 + expf(-v)) in fp32,
# but PyTorch's build and this one's (-fmad=false) may compile expf's
# libdevice code apart (on the CPU the plain version and F.silu take other
# exps: up to 2 fp32 ulps, tests/test_torch_bias_act.py); none and ReLU are
# held bit for bit
EPILOGUE_SILU_ULPS = {torch.bfloat16: 1, torch.float32: 2}
_ACTS = {"none": 0, "relu": 1, "silu": 2}


def epilogue_operand(shape, gen, dev, dtype=torch.bfloat16, fmt=torch.channels_last):
    """2 N(0, 1) in `dtype`, channels_last where 4-D (the card's layout)."""
    t = (2 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
    return t.contiguous(memory_format=fmt) if t.dim() == 4 else t


def _epilogue_case(layout, c, h, w, n, act, dtype):
    """One case: y (n, c, h, w) in `layout` (channels_last, nchw, or an
    offset view whose base is not 16-byte aligned), b (c,)."""
    def make(dev):
        gen = torch.Generator(device=dev).manual_seed(26)
        if layout == "offset":
            flat = epilogue_operand((3 + n * c * h * w,), gen, dev, dtype)
            y = flat[3:].view(n, h, w, c).permute(0, 3, 1, 2)
        else:
            fmt = torch.contiguous_format if layout == "nchw" else torch.channels_last
            y = epilogue_operand((n, c, h, w), gen, dev, dtype, fmt)
        return y, epilogue_operand((c,), gen, dev, dtype), act
    return make


def _epilogue_cases():
    """The layouts and dtypes beside the main path's (fp32, NCHW, a count
    that is not a multiple of the vector, a base that is not 16-byte
    aligned), then every distinct shape of EPILOGUE_SHAPES at b128, bf16."""
    cases = {}
    for aname, act in _ACTS.items():
        for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            for label, layout, shape in (("C277", "nhwc", (8, 277, 20, 20)),
                                         ("nchw", "nchw", (8, 64, 40, 40)),
                                         ("ragged", "nhwc", (1, 277, 3, 5)),
                                         ("offset", "offset", (2, 12, 5, 7))):
                n, c, h, w = shape
                cases[f"{label}_{dname}_{aname}"] = _epilogue_case(layout, c, h, w, n, act, dtype)
    seen = set()
    for model, shapes in EPILOGUE_SHAPES.items():
        for c, stride, act in shapes:
            s = EPILOGUE_IMG // stride
            if (c, s, act) not in seen:
                seen.add((c, s, act))
                cases[f"{model}_C{c}_{s}x{s}_{[*_ACTS][act]}"] = _epilogue_case(
                    "nhwc", c, s, s, EPILOGUE_BATCH, act, torch.bfloat16)
    return cases


def _residual_case(layout, c, h, w, n, act, dtype):
    """One case of the residual form: _epilogue_case's y and b, x as y
    (laid out alike, an offset view where y is one), alpha drawn as the
    seeded weights draw it, N(1, 0.1)."""
    def make(dev):
        y, b, _ = _epilogue_case(layout, c, h, w, n, act, dtype)(dev)
        x = torch.empty_like(y) if layout != "offset" else (
            torch.empty(3 + y.numel(), dtype=dtype, device=dev)[3:].view(n, h, w, c)
            .permute(0, 3, 1, 2))
        gen = torch.Generator(device=dev).manual_seed(27)
        x.copy_(epilogue_operand(y.shape, gen, dev, dtype))
        alpha = (1 + 0.1 * torch.randn(1, generator=gen, device=dev)).to(dtype)
        return y, b, act, x, alpha
    return make


def _residual_cases():
    """The layouts and dtypes beside the main path's (fp32, NCHW, a count
    that is not a multiple of the vector, bases that are not 16-byte aligned:
    the scalar kernel), then every distinct shape of RESIDUAL_SHAPES at b1,
    bf16."""
    cases = {}
    for aname, act in _ACTS.items():
        for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            for label, layout, shape in (("nchw", "nchw", (8, 64, 40, 40)),
                                         ("ragged", "nhwc", (1, 277, 3, 5)),
                                         ("offset", "offset", (2, 12, 5, 7))):
                n, c, h, w = shape
                cases[f"residual_{label}_{dname}_{aname}"] = _residual_case(layout, c, h, w, n,
                                                                             act, dtype)
    for model, shapes in RESIDUAL_SHAPES.items():
        for c, stride, act in shapes:
            s = RESIDUAL_IMG[model] // stride
            cases[f"residual_{model}_C{c}_{s}x{s}_{[*_ACTS][act]}"] = _residual_case(
                "nhwc", c, s, s, 1, act, torch.bfloat16)
    return cases


def unfused_epilogue(y, b, act):
    """PyTorch's unfused epilogue on a conv output `y`, in place as the conv
    leaves it to PyTorch: `add_` of the broadcast bias, then the activation."""
    import torch.nn.functional as F

    z = y.add_(b.reshape(1, -1, 1, 1))
    return (z, F.relu(z), F.silu(z))[act]


def max_ulps(got, want):
    """The largest |got - want| in ulps of want's dtype at want's value."""
    fi = torch.finfo(want.dtype)
    w = want.double()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(fi.tiny)))) * fi.eps
    return float(((got.double() - w).abs() / ulp).max())


def check_epilogue(args, got, what):
    """The kernel's `got` = act(y + b) against the plain version and the
    unfused sequence on the card: equal bit for bit, SiLU within
    EPILOGUE_SILU_ULPS; y's strides kept. Returns (max SiLU ulps, elements
    that differ)."""
    from yololp_tpu_torch.ops.cuda_bias_act import bias_act_plain

    y, b, act = args
    if got.stride() != y.stride():
        raise AssertionError(f"bias_act {what}: strides {got.stride()}, y's {y.stride()}")
    ulps, differ = 0.0, 0
    for name, want in (("plain", bias_act_plain(y, b, act)),
                       ("unfused", unfused_epilogue(y.clone(), b, act))):
        if torch.equal(got, want):
            continue
        n = int((got != want).sum())
        u = max_ulps(got, want)
        if act != 2 or u > EPILOGUE_SILU_ULPS[y.dtype]:
            raise AssertionError(f"bias_act {what} act {act}: {n} elements differ from the "
                                 f"{name} version, up to {u:.3g} ulps")
        ulps, differ = max(ulps, u), max(differ, n)
    return ulps, differ


def check_residual(args, got, what):
    """The residual form's `got` = act(y + b) + alpha * x: bit for bit with
    the sequence the card ran before it (the plain form's kernel, then
    PyTorch's alpha * x and add, a launch of its own here), and with the
    plain version wherever the epilogues agree (everywhere for none and
    ReLU; SiLU's epilogue within EPILOGUE_SILU_ULPS, check_epilogue's
    allowance, whose ulps grow in ulps of a sum that cancels); y's strides
    kept. Returns the largest |got - unfused| (0 where it passes) and the
    largest ulps of got from the plain version over every element."""
    from yololp_tpu_torch.ops.cuda_bias_act import bias_act, bias_act_plain

    y, b, act, x, alpha = args
    if got.stride() != y.stride():
        raise AssertionError(f"bias_act residual {what}: strides {got.stride()}, y's {y.stride()}")
    a, a_plain = bias_act(y, b, act), bias_act_plain(y, b, act)
    unfused = a + alpha * x
    diff = float((got.float() - unfused.float()).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, unfused):
        raise AssertionError(f"bias_act residual {what}: {int((got != unfused).sum())} elements "
                             f"differ from the plain form's kernel, then alpha * x and the add, by "
                             f"up to {diff}")
    same = a == a_plain
    if (act != 2 and not bool(same.all())) or max_ulps(a, a_plain) > EPILOGUE_SILU_ULPS[y.dtype]:
        raise AssertionError(f"bias_act residual {what} act {act}: the epilogue differs from its "
                             f"plain version at {int((~same).sum())} elements")
    plain = bias_act_plain(*args)
    if not torch.equal(got[same], plain[same]):
        raise AssertionError(f"bias_act residual {what}: {int((got[same] != plain[same]).sum())} "
                             "elements differ from the plain version where the epilogues agree")
    return diff, max_ulps(got, plain)


def check_bias_act(args, got, what):
    """check_epilogue, or check_residual where the case hands in x and
    alpha."""
    return (check_residual if len(args) > 3 else check_epilogue)(args, got, what)


# ---------------- nms_gate (csrc/nms_gate.cu) ----------------

GATE_THRESHOLDS = (0.4, 0.7, 0.25)  # fp32 rounds the first up, the second down; exact
# (B, A): odd, one image of 8400, the L6 cell's 34000 anchors alone, and the
# cells' b128 x 8400 and b32 x 34000
GATE_SHAPES = ((3, 517), (4, 8400), (1, 34000), (128, 8400), (32, 34000))


def gate_decode(b, a, gen, dev):
    """A synthetic (b, a, 290) fp32 decode on `dev`: boxes in pixels, obj 1,
    corners, sigmoid scores."""
    xy = torch.rand(b, a, 2, generator=gen, device=dev) * 640
    wh = torch.rand(b, a, 2, generator=gen, device=dev) * 100 + 1
    corners = torch.rand(b, a, 8, generator=gen, device=dev) * 640
    cls = torch.sigmoid(torch.randn(b, a, 277, generator=gen, device=dev) * 3 - 2)
    return torch.cat([xy, wh, torch.ones(b, a, 1, device=dev), corners, cls], -1).contiguous()


def gate_edge_decode(gen, dev, thres):
    """A (2, 96, 290) decode: rows 0-23 with exact ties inside each task, rows
    24-31 with NaNs (a score, two in one task, obj, all scores, a box
    coordinate), rows 32-55 whose score is exactly fp32(thres) or one of its
    two fp32 neighbours (task maxima v, v, 2v, 0, 4v, 0, 0, 0: exact partial
    sums in either gate)."""
    tasks = [(0, 31), (31, 24)] + [(55 + 37 * i, 37) for i in range(6)]
    pred = gate_decode(2, 96, gen, dev)
    for row in range(24):
        for k, (s, w) in enumerate(tasks):
            at = torch.randperm(w, generator=gen, device=dev)[: 2 + (row + k) % 3]
            pred[:, row, 13 + s + at] = 0.9 - 0.001 * k
    nan = float("nan")
    pred[:, 24, 13 + 31 + 5] = nan
    pred[:, 25, 13 + 2] = nan
    pred[:, 25, 13 + 9] = nan
    pred[:, 26, 4] = nan
    pred[:, 27, 13:] = nan
    pred[:, 28, 0] = nan
    pred[:, 29, 289] = nan
    t32 = np.float32(thres)
    for i, v in enumerate((np.nextafter(t32, np.float32(0)), t32,
                           np.nextafter(t32, np.float32(1)))):
        for j in range(8):
            row = 32 + 8 * i + j
            pred[:, row, 13:] = 0.0
            for (s, w), scale in zip(tasks, (1, 1, 2, 0, 4, 0, 0, 0)):
                pred[:, row, 13 + s + (j * 5) % w] = float(v) * scale
    return pred


def gate_equal(args, got, what):
    """Raise unless the kernel's four outputs `got` equal the plain
    version's on the card bit for bit (floats compared as their bits, so NaN
    too). Returns the rows that passed the gate and the largest |kernel -
    plain| over the float outputs (0 where the bits agree, inf where one
    side is NaN)."""
    from yololp_tpu_torch.ops.cuda_nms_gate import nms_gate_plain

    pred, thres, compat = args
    want = nms_gate_plain(pred, thres, compat)
    err = 0.0
    for name, g, w in zip(("box", "score", "rest", "passed"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"nms_gate {what}: {name} is {tuple(g.shape)} {g.dtype}, the "
                                 f"plain version's {tuple(w.shape)} {w.dtype}")
        gb = g.view(torch.int32) if g.dtype == torch.float32 else g
        wb = w.view(torch.int32) if w.dtype == torch.float32 else w
        if g.dtype == torch.float32 and g.numel():
            diff = (g - w).abs().nan_to_num(nan=float("inf"))
            err = max(err, float(torch.where(gb == wb, 0.0, diff).max()))
        if not torch.equal(gb, wb):
            raise AssertionError(f"nms_gate {what} (thres {thres}, compat {compat}): {name} "
                                 f"differs from the plain version in {int((gb != wb).sum())} "
                                 f"elements, by up to {err}")
    return int(got[3].sum()), err


def _gate_cases():
    """The edge decode at each threshold, the shapes at 0.4, each with
    compat_ad4_bug off and on, and an offset view (4 bytes past a 16-byte
    boundary) of the first three shapes."""
    def edge(thres, compat):
        return lambda dev: (gate_edge_decode(torch.Generator(device=dev).manual_seed(27), dev,
                                             thres), thres, compat)

    def shape(b, a, compat, offset=False):
        def make(dev):
            pred = gate_decode(b, a, torch.Generator(device=dev).manual_seed(b * a), dev)
            if offset:
                pred = pred.view(-1)[1:1 + (b * a - 1) * 290].view(1, b * a - 1, 290)
            return pred, 0.4, compat
        return make

    cases = {}
    for compat in (False, True):
        for thres in GATE_THRESHOLDS:
            cases[f"edges_{thres}_compat{int(compat)}"] = edge(thres, compat)
        for b, a in GATE_SHAPES:
            cases[f"{b}x{a}_compat{int(compat)}"] = shape(b, a, compat)
    for b, a in GATE_SHAPES[:3]:
        cases[f"{b}x{a}_offset_view"] = shape(b, a, False, offset=True)
    return cases


# ---------------- quantize_codes (csrc/quantize.cu) ----------------

# the yololps int8 plan's quantizes of a b128 batch at 640: the largest (the
# input of backbone.ERBlock_2_down) and the head's 20x20 maps (its smallest);
# tests/test_torch_quantize.py holds them to the plan
QUANTIZE_SHAPES = {"largest": (128, 32, 320, 320), "head_20x20": (128, 256, 20, 20)}
QUANTIZE_AMAX = 6.0  # a calibrated amax that 2 N(0, 1) passes: some codes clip


def quantize_edges(dtype=torch.float32):
    """Values where the codes are hardest at inv_scale 1: every half-way point
    and every integer of the code range, the clip's edges and beyond them,
    +-inf, -0.0, the dtype's subnormals and large finite values."""
    fi = torch.finfo(dtype)
    k = torch.arange(-128, 128, dtype=torch.float32)
    special = torch.tensor([float("inf"), -float("inf"), -0.0, 0.0, 127.49, 127.5, 128.5, -128.5,
                            -128.49, -129.0, 200.0, -200.0, 1e30, -1e30])
    tiny = torch.tensor([fi.tiny / 2, -fi.tiny / 2, fi.tiny * 2 ** -5, fi.max, -fi.max])
    return torch.cat([k + 0.5, k, k + 0.25, special, tiny]).to(dtype)


def quantize_operand(layout, shape, dtype, gen, dev):
    """2 N(0, 1) in `dtype`: `shape` channels_last ("nhwc"), contiguous
    ("nchw"), or an offset view of channels_last layout whose base is 3
    elements past an allocation."""
    n = int(np.prod(shape))
    if layout == "offset":
        flat = (2 * torch.randn(3 + n, generator=gen, device=dev)).to(dtype)
        s0, c, h, w = shape
        return flat[3:].view(s0, h, w, c).permute(0, 3, 1, 2)
    t = (2 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
    return t.contiguous(memory_format=torch.channels_last) if layout == "nhwc" else t


def _quantize_cases():
    """The edges at inv_scale 1 and at a calibrated scale, in both dtypes;
    fp32 NCHW and NHWC; an odd count; offset views; then the plan's largest
    and smallest maps at b128, bf16 channels_last."""
    from yololp_tpu_torch.ops.cuda_conv import inv_host_scale

    inv = inv_host_scale(QUANTIZE_AMAX)

    def edges(dtype, scale):
        return lambda dev: (quantize_edges(dtype).to(dev), scale)

    def operand(layout, shape, dtype):
        return lambda dev: (quantize_operand(layout, shape, dtype,
                                             torch.Generator(device=dev).manual_seed(24), dev),
                            inv)

    cases = {}
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        cases[f"edges_{dname}"] = edges(dtype, 1.0)
        cases[f"edges_scaled_{dname}"] = edges(dtype, inv)
        cases[f"odd_{dname}"] = operand("nhwc", (1, 277, 3, 5), dtype)
        cases[f"offset_{dname}"] = operand("offset", (2, 12, 5, 7), dtype)
    cases["nchw_fp32"] = operand("nchw", (8, 64, 40, 40), torch.float32)
    cases["nhwc_fp32"] = operand("nhwc", (8, 64, 40, 40), torch.float32)
    for name, shape in QUANTIZE_SHAPES.items():
        cases[f"{name}_bf16"] = operand("nhwc", shape, torch.bfloat16)
    return cases


def check_quantize(args, got, what):
    """The kernel's codes equal the plain version's bit for bit, with x's
    strides."""
    from yololp_tpu_torch.ops.cuda_quantize import quantize_codes_plain

    x, inv_scale = args
    if got.dtype != torch.int8 or got.stride() != x.stride():
        raise AssertionError(f"quantize_codes {what}: {got.dtype}, strides {got.stride()}, "
                             f"x's {x.stride()}")
    want = quantize_codes_plain(x, inv_scale)
    if not torch.equal(got, want):
        raise AssertionError(f"quantize_codes {what}: {int((got != want).sum())} of {got.numel()} "
                             "codes differ from the plain version")


# ---------------- every op ----------------


class OpCases(NamedTuple):
    cases: Callable[[], dict]  # {case: make(dev) -> the op's arguments}
    check: Callable  # (args, got, what): raises unless got equals the plain version's
    refusals: list  # [(make(dev), exception, match)]
    empty: Callable  # make(dev): arguments whose output (or reduction) is empty


def _z(dev, *shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=dev)


OPS = {
    "greedy_nms_mask": OpCases(
        lambda: {name: _nms_case(name) for name in mask_cases(np.random.default_rng(1))},
        _nms_check,
        [(lambda dev: (_z(dev, 1, 1025, 4), torch.ones(1, 1025, device=dev), 0.45), ValueError,
          "limit"),
         (lambda dev: (_z(dev, 2, 8, 4).transpose(0, 1), torch.ones(8, 2, device=dev), 0.45),
          ValueError, "contiguous"),
         (lambda dev: (_z(dev, 2, 8, 4).double(), torch.ones(2, 8, device=dev), 0.45), TypeError,
          "float32")],
        lambda dev: (_z(dev, 0, 8, 4), torch.ones(0, 8, device=dev), 0.45)),
    "int8_conv": OpCases(
        lambda: {name: _int8_case(name) for name in int8_specs()},
        _int8_check,
        [(lambda dev: (_z(dev, 1, 8, 8, 32), _z(dev, 16, 3, 3, 32, dtype=torch.int8),
                       torch.ones(16, device=dev), torch.ones(16, device=dev), 1, True, 0),
          TypeError, "int8"),
         (lambda dev: (_z(dev, 1, 8, 8, 32, dtype=torch.int8).permute(0, 2, 1, 3),
                       _z(dev, 16, 3, 3, 32, dtype=torch.int8), torch.ones(16, device=dev),
                       torch.ones(16, device=dev), 1, True, 0), ValueError, "contiguous"),
         (lambda dev: (_z(dev, 1, 8, 8, 32, dtype=torch.int8),
                       _z(dev, 16, 3, 3, 32, dtype=torch.int8), torch.ones(16, device=dev),
                       torch.ones(16, device=dev), 1, True, 7), TypeError, "out_mode")],
        lambda dev: (_z(dev, 0, 8, 8, 32, dtype=torch.int8), _z(dev, 16, 3, 3, 32, dtype=torch.int8),
                     torch.ones(16, device=dev), torch.ones(16, device=dev), 1, True, 0)),
    "matmul": OpCases(
        lambda: _mm_cases(nt=False),
        lambda args, got, what: matmul_error(*args, got, what),
        [(lambda dev: (_z(dev, 64, 32), _z(dev, 32, 16)), TypeError, "int8"),
         (lambda dev: (_z(dev, 64, 32, dtype=torch.int8), _z(dev, 16, 32, dtype=torch.int8).t()),
          ValueError, "contiguous"),
         (lambda dev: (_z(dev, 64, 32, dtype=torch.int8), _z(dev, 16, 32, dtype=torch.int8)),
          ValueError, "inner")],
        lambda dev: (_z(dev, 64, 0, dtype=torch.int8), _z(dev, 0, 16, dtype=torch.int8))),
    "matmul_nt": OpCases(
        lambda: _mm_cases(nt=True),
        lambda args, got, what: matmul_error(args[0], args[1].t(), got, what),
        # rows 360 bytes apart, and a transposed (column-strided) b_t
        [(lambda dev: (_z(dev, 64, 48, dtype=torch.int8)[:, :40],
                       _z(dev, 16, 3, 3, 40, dtype=torch.int8)[:, 1, 1, :]), ValueError,
          "16 bytes"),
         (lambda dev: (_z(dev, 64, 32, dtype=torch.int8), _z(dev, 32, 16, dtype=torch.int8).t()),
          ValueError, "16 bytes")],
        lambda dev: (_z(dev, 0, 32, dtype=torch.int8), _z(dev, 16, 32, dtype=torch.int8))),
    "bias_act": OpCases(
        lambda: _epilogue_cases() | _residual_cases(),
        check_bias_act,
        [(lambda dev: (_z(dev, 2, 8, 4, 4, dtype=torch.float16),
                       _z(dev, 8, dtype=torch.float16), 1), TypeError, "float32"),
         (lambda dev: (_z(dev, 2, 8, 4, 4), _z(dev, 4), 1), ValueError, "channels"),
         (lambda dev: (_z(dev, 2, 8, 4, 4), _z(dev, 8), 3), ValueError, "act"),
         (lambda dev: (_z(dev, 2, 4, 8, 4).transpose(1, 2), _z(dev, 8), 1), ValueError,
          "channels_last or contiguous"),
         # the residual form's
         (lambda dev: (_z(dev, 2, 8, 4, 4), _z(dev, 8), 1, _z(dev, 2, 8, 4, 2), _z(dev, 1)),
          ValueError, "shape"),
         (lambda dev: (_z(dev, 2, 8, 4, 4), _z(dev, 8), 1, _z(dev, 2, 8, 4, 4),
                       _z(dev, 1, dtype=torch.bfloat16)), TypeError, "alpha"),
         (lambda dev: (_z(dev, 2, 8, 4, 4), _z(dev, 8), 1,
                       _z(dev, 2, 8, 4, 4).contiguous(memory_format=torch.channels_last),
                       _z(dev, 1)), ValueError, "laid out"),
         (lambda dev: (_z(dev, 2, 8, 4, 4), _z(dev, 8), 1, _z(dev, 2, 8, 4, 4), _z(dev, 2)),
          ValueError, "one element"),
         (lambda dev: (_z(dev, 2, 8, 4, 4), _z(dev, 8), 1, _z(dev, 2, 8, 4, 4), _z("cpu", 1)),
          ValueError, "alpha on cpu"),
         (lambda dev: (_z(dev, 2, 8, 4, 4), _z(dev, 8), 1, _z(dev, 2, 8, 4, 4), None),
          ValueError, "together")],
        lambda dev: (_z(dev, 0, 8, 4, 4), _z(dev, 8), 1)),
    "nms_gate": OpCases(
        _gate_cases,
        gate_equal,
        [(lambda dev: (_z(dev, 2, 8, 290, dtype=torch.float64), 0.4, False), TypeError,
          "float32"),
         (lambda dev: (_z(dev, 2, 8, 289), 0.4, False), ValueError, "290"),
         (lambda dev: (_z(dev, 2, 8, 290).transpose(0, 1), 0.4, False), ValueError,
          "contiguous")],
        lambda dev: (_z(dev, 2, 0, 290), 0.4, False)),
    "quantize_codes": OpCases(
        _quantize_cases,
        check_quantize,
        [(lambda dev: (_z(dev, 2, 8, 4, 4, dtype=torch.int8), 1.0), TypeError, "floating"),
         (lambda dev: (_z(dev, 2, 8, 4, 4, dtype=torch.float16), 1.0), TypeError, "float32"),
         (lambda dev: (_z(dev, 2, 8, 4, 4, dtype=torch.float64), 1.0), TypeError, "float32"),
         (lambda dev: (_z(dev, 2, 8, 4, 8)[..., ::2], 1.0), ValueError, "dense")],
        lambda dev: (_z(dev, 0, 8, 4, 4, dtype=torch.bfloat16), 1.0)),
}


# ---------------- the evaler on the card (chip_smoke.py phase 12) ----------------


@torch.no_grad()
def randomize_parameters(model: torch.nn.Module, gen: torch.Generator, gain: float = 0.7):
    """Every kernel He-style (std gain/sqrt(fan_in)), BN scale and variance in
    [0.5, 1.5], BN shift and mean ~N(0, 0.1), conv biases init + N(0, 0.1),
    and every other parameter (a ScaleLayer's scale, a BottleRep's alpha)
    init + N(0, 0.1): so the head scores vary and activations stay finite
    through the deep graph."""
    def normal(t, std):
        return torch.randn(t.shape, generator=gen) * std

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, torch.nn.Conv2d) else w.shape[0] * w[0, 0].numel()
            w.copy_(normal(w, gain / fan_in ** 0.5))
            if m.bias is not None:
                m.bias.add_(normal(m.bias, 0.1))
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=gen))
            m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=gen))
            m.bias.copy_(normal(m.bias, 0.1))
            m.running_mean.copy_(normal(m.running_mean, 0.1))
        else:
            for p in m.parameters(recurse=False):
                p.add_(normal(p, 0.1))


def labelled_frames(rng, n, size, max_boxes=32):
    """n RGB uint8 frames (n, size, size, 3) and their labels in memory: 1-4
    plate-shaped boxes a frame, rows [pro, alp, ads0..5, cx, cy, w, h,
    x1..y4] normalized, padded to max_boxes with a (n, max_boxes) mask."""
    imgs = rng.integers(0, 256, (n, size, size, 3), np.uint8)
    labels = np.zeros((n, max_boxes, 20), np.float32)
    labels[..., :8] = -1
    masks = np.zeros((n, max_boxes), np.float32)
    for i in range(n):
        k = int(rng.integers(1, 5))
        w = rng.uniform(0.06, 0.3, k)
        h = w * size / 3.78 / size
        cxy = rng.uniform(0.2, 0.8, (k, 2))
        x1, y1, x2, y2 = cxy[:, 0] - w / 2, cxy[:, 1] - h / 2, cxy[:, 0] + w / 2, cxy[:, 1] + h / 2
        labels[i, :k, 0] = rng.integers(0, 31, k)
        labels[i, :k, 1] = rng.integers(0, 24, k)
        labels[i, :k, 2:8] = rng.integers(0, 37, (k, 6))
        labels[i, :k, 8:12] = np.stack([cxy[:, 0], cxy[:, 1], w, h], -1)
        labels[i, :k, 12:20] = np.stack([x1, y1, x1, y2, x2, y2, x2, y1], -1)
        masks[i, :k] = 1
    return imgs, labels, masks


def loader_batches(imgs, labels, masks, batch):
    """The loader's batches (images, labels, masks, paths, shapes), the last
    one short."""
    return [(imgs[b0:b0 + batch], labels[b0:b0 + batch], masks[b0:b0 + batch],
             [f"frame{b0 + j:03d}" for j in range(len(imgs[b0:b0 + batch]))],
             [None] * len(imgs[b0:b0 + batch])) for b0 in range(0, len(imgs), batch)]


def own_gts(preds):
    """Each image's first two detections of positive size (random weights
    also decode inverted boxes) as its gts, in the metric's target layout."""
    own = []
    for d in preds:
        d = d[(d[:, 2] - d[:, 0] > 1) & (d[:, 3] - d[:, 1] > 1)][:2]
        own.append(np.concatenate([d[:, 20:28], d[:, 0:4], d[:, 4:12]], 1))
    return own


def eval_on_card(ev, run_fn, decode_module, loader, kernels):
    """Evaler.predict + eval through `run_fn` with the launches of the
    named `kernels` (ops/_build.py) counted over the predict; then the
    plain CPU NMS on the card's own decodes (a forward hook on
    `decode_module` keeps them) must give the same detections and metric.
    Returns (metric, {kernel: launches}, detections, the metric with each
    image's own first detections as its gts, targets)."""
    from yololp_tpu_torch.ops import _build
    from yololp_tpu_torch.ops.nms import non_max_suppression

    decodes = []
    hook = decode_module.register_forward_hook(lambda m, a, out: decodes.append(out.detach()))
    try:
        before = {k: _build.launches(k) for k in kernels}
        preds, targets = ev.predict(run_fn, loader)
        torch.cuda.synchronize()
        launches = {k: _build.launches(k) - n for k, n in before.items()}
    finally:
        hook.remove()
    metric = ev.eval(preds, targets)
    if len(decodes) != len(loader):
        raise AssertionError(f"{len(decodes)} decodes for {len(loader)} batches")
    cpu_preds = []
    for (imgs, *_), pred in zip(loader, decodes):
        det, valid, num = non_max_suppression(pred.float().cpu(), conf_thres=ev.conf_thres,
                                              iou_thres=ev.iou_thres, max_det=ev.max_det)
        cpu_preds += [det[j][valid[j]][: int(num[j])].numpy() for j in range(len(imgs))]
    for i, (a, b) in enumerate(zip(preds, cpu_preds)):
        if not np.array_equal(a, b):
            raise AssertionError(f"image {i}: the card's eval detections != plain CPU NMS on its decode")
    metric_cpu = ev.eval(cpu_preds, targets)
    if metric != metric_cpu:
        raise AssertionError(f"eval metric on the card {metric} != plain CPU NMS's {metric_cpu}")
    # on random weights no detection meets a label, so every bucket is empty;
    # each image's own first detections, taken as its gts, fill the last one
    own = own_gts(cpu_preds)
    metric_own = ev.eval(preds, own)
    if metric_own != ev.eval(cpu_preds, own) or (sum(map(len, own)) and metric_own[5][-1] == -1):
        raise AssertionError(f"eval metric on the card's own detections as gts: {metric_own}")
    return metric, launches, preds, metric_own, targets

"""Height-sharded inference over a (data, spatial) mesh: the counterpart of
XLA's SPMD partitioner on the JAX package's `image_sharding`
(yololp_tpu/parallel/mesh.py:63-75, tests/test_parallel.py:35-62), which
splits a jitted forward's image height over the mesh's 'spatial' axis and
inserts the convs' halo exchanges itself.

One controller drives every band of rows, each in a thread of its own,
through the port's own module forwards: the backbone, the neck and the
head's pred maps (models/effidehead.py:Detect.pred_maps). A thread-local
TorchFunctionMode (`_BandMode`) rewrites the only ops of the zoo that mix
rows:

  * a conv that is taller than one row or strided (the 3x3 convs at stride 1
    and 2, and the 1x1 at stride 2 of a RepVGG block's train graph): the rows
    its window reaches beyond the band come from the bands that hold them,
    zero rows pad only the image's top and bottom, and the conv runs with
    padding (0, pw);
  * a max-pool (the 5x5 stride-1 pools of SPPF/CSPSPPF): the same, with
    -inf rows at the image's edges;
  * ConvTranspose2d(k=2, s=2): no halo, a band's rows double. Any other
    transposed geometry raises.

Any other call must keep every row to itself (`_ROW_LOCAL`, among them the
deploy convs' epilogue op `yololp_torch::bias_act`, a cat along
channels, BN in eval mode), or it raises: nothing gathers the whole image to
run an op.

The bands of one data row meet at a barrier before each of those ops: each
posts its input, then takes the rows it needs from the others' (from bands
two or more away where a band is thinner than the halo). Bands are cut on
the rows of the coarsest level (stride 32, or 64 with a 4-level head), so a
band holds whole rows at every level, every stride-2 boundary falls on an
even row, and a band's place at a level follows from its height there.

The per-level pred maps of a data row are gathered along H in band order
onto the row's first device, where the head's decode (Detect.decode) builds
the anchors from the whole maps: per level H then W, levels concatenated, as
the unsharded forward orders them.

On a card each thread runs on its device's default stream. A halo from
another card is a `.to()` of its rows, which PyTorch runs after the work
already queued on both cards' current streams and before what follows on
the consumer's; on one card a halo is a slice of the other band's tensor, on
the same stream.

Inference only. Train mode raises: BN's statistics would be per band, and no
JAX entry point trains on a spatial mesh. The int8 model raises too: XLA
cannot partition a `pallas_call`, so the JAX package has no int8 spatial path
either.
"""

from __future__ import annotations

import contextlib
import functools
import queue
import threading
import weakref
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from yololp_tpu_torch.ops.division import unit_pixels
from yololp_tpu_torch.ops.nms import non_max_suppression
from yololp_tpu_torch.parallel.infer import replicate
from yololp_tpu_torch.parallel.mesh import image_sharding
from yololp_tpu_torch.quant.int8_infer import Int8Conv2d, Int8Handoff, Int8RepBlock
from yololp_tpu_torch.quant.quantize import model_device_dtype

# a band that never reaches an exchange breaks it for the others after this
BARRIER_TIMEOUT_S = 600.0

_T = torch.Tensor
# calls that keep every row to itself
_ROW_LOCAL = {F.relu, torch.relu, F.silu, torch.sigmoid, _T.sigmoid, torch.add, torch.mul,
              _T.add, _T.mul, _T.__add__, _T.__radd__, _T.__mul__, _T.__rmul__, _T.dim, _T.size,
              _T.numel, _T.is_contiguous, torch.ops.yololp_torch.bias_act}
# tensor attributes read under the mode (a getset descriptor's __get__)
_ATTRIBUTES = {"dtype", "shape", "device", "ndim", "is_cuda", "layout", "grad_fn",
               "requires_grad"}


class SpatialError(ValueError):
    """A model or an op that the spatial path cannot run band by band."""


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _filled(x: torch.Tensor, n: int, value: float) -> torch.Tensor:
    return x.new_full((x.shape[0], x.shape[1], n, x.shape[3]), value)


class _Exchange:
    """The halo exchange of one data row's bands: `blocks` holds each band's
    [start, stop) rows at the coarsest level; two sets of slots, used in
    turns, so that one barrier an op suffices (a band can post to a set
    again only after every band has passed the next barrier, that is, after
    every band has read it)."""

    def __init__(self, blocks):
        self.blocks = blocks
        self.barrier = threading.Barrier(len(blocks), timeout=BARRIER_TIMEOUT_S)
        self.slots = ([None] * len(blocks), [None] * len(blocks))


class _BandMode(TorchFunctionMode):
    """Runs one band's ops: the row-mixing ones over the band's rows and
    their halos, the row-local ones as they are; anything else raises."""

    def __init__(self, exchange: _Exchange, col: int):
        super().__init__()
        self.ex, self.col, self.step = exchange, col, 0
        self.halo_rows = self.halo_bytes = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.conv2d:
            return self._conv(*args, **kwargs)
        if func is F.max_pool2d:
            return self._max_pool(*args, **kwargs)
        if func is F.conv_transpose2d:
            return self._conv_transpose(*args, **kwargs)
        if func in _ROW_LOCAL or _attribute(func) in _ATTRIBUTES:
            return func(*args, **kwargs)
        if func is torch.cat:
            tensors = args[0] if args else kwargs["tensors"]
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            if dim % tensors[0].dim() != 2:
                return func(*args, **kwargs)
        elif func is F.batch_norm:
            training = args[5] if len(args) > 5 else kwargs.get("training", False)
            if not training:
                return func(*args, **kwargs)
        elif func in (_T.reshape, _T.view) and args[0].dim() < 4:  # a ScaleLayer's weight
            return func(*args, **kwargs)
        name = getattr(func, "__qualname__", None) or repr(func)
        raise SpatialError(f"{name}: not known to keep image rows apart, so a band cannot "
                           "run it (the spatial path runs convs, max-pools, 2x2/s2 transposed "
                           "convs and row-local ops only)")

    def _window(self, x, k: int, s: int, p: int, d: int, fill: float) -> torch.Tensor:
        """`x` extended by the rows that a window of `k` rows (stride `s`,
        padding `p`, dilation `d`) over the whole map reaches from this
        band's output rows; `fill` outside the map."""
        b0, b1 = self.ex.blocks[self.col]
        f, rem = divmod(x.shape[2], b1 - b0)
        height = self.ex.blocks[-1][1] * f
        if rem or f % s or (height + 2 * p - d * (k - 1) - 1) // s + 1 != height // s:
            raise SpatialError(f"a window of {k} rows at stride {s}, padding {p}, on a band of "
                               f"{x.shape[2]} rows: its output would not split on the "
                               "bands' rows")
        a, b = b0 * f, b1 * f
        lo, hi = a - p, (b // s - 1) * s - p + d * (k - 1) + 1

        slot = self.ex.slots[self.step % 2]
        self.step += 1
        slot[self.col] = x
        self.ex.barrier.wait()
        parts = [_filled(x, -lo, fill)] if lo < 0 else []
        for j, (c0, c1) in enumerate(self.ex.blocks):
            s0, s1 = c0 * f, c1 * f
            r0, r1 = max(lo, s0), min(hi, s1)
            if r0 >= r1:
                continue
            src = slot[j]
            if src.shape[2] != s1 - s0:
                raise SpatialError(f"band {j} posted {src.shape[2]} rows where {s1 - s0} "
                                   "were due: the bands ran different graphs")
            rows = src[:, :, r0 - s0:r1 - s0]
            if j != self.col:
                rows = rows.to(x.device, non_blocking=True)
                self.halo_rows += r1 - r0
                self.halo_bytes += rows.numel() * rows.element_size()
            parts.append(rows)
        if hi > height:
            parts.append(_filled(x, hi - height, fill))
        if len(parts) == 1:
            return parts[0]
        out = torch.cat(parts, 2)
        if x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous():
            out = out.contiguous(memory_format=torch.channels_last)
        return out

    def _conv(self, input, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):  # noqa: A002
        if isinstance(padding, str):
            raise SpatialError(f"a conv with padding {padding!r}")
        (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
        kh = weight.shape[2]
        if kh == 1 and sh == 1 and ph == 0:
            return F.conv2d(input, weight, bias, stride, padding, dilation, groups)
        x = self._window(input, kh, sh, ph, dh, 0.0)
        return F.conv2d(x, weight, bias, (sh, sw), (0, pw), (dh, dw), groups)

    def _max_pool(self, input, kernel_size, stride=None, padding=0, dilation=1,  # noqa: A002
                  ceil_mode=False, return_indices=False):
        if ceil_mode or return_indices:
            raise SpatialError("a max-pool with ceil_mode or indices")
        (kh, kw), (ph, pw), (dh, dw) = _pair(kernel_size), _pair(padding), _pair(dilation)
        sh, sw = _pair(stride if stride else kernel_size)
        x = self._window(input, kh, sh, ph, dh, float("-inf"))
        return F.max_pool2d(x, (kh, kw), (sh, sw), (0, pw), (dh, dw))

    def _conv_transpose(self, input, weight, bias=None, stride=1, padding=0,  # noqa: A002
                        output_padding=0, groups=1, dilation=1):
        geometry = (weight.shape[2], _pair(stride)[0], _pair(padding)[0],
                    _pair(output_padding)[0], _pair(dilation)[0])
        if geometry != (2, 2, 0, 0, 1):
            raise SpatialError(f"a transposed conv of (kernel, stride, padding, output_padding, "
                               f"dilation) {geometry} along H: only (2, 2, 0, 0, 1) needs no halo")
        return F.conv_transpose2d(input, weight, bias, stride, padding, output_padding, groups,
                                  dilation)


def _attribute(func) -> Optional[str]:
    """The attribute's name where `func` reads a tensor attribute."""
    return getattr(getattr(func, "__self__", None), "__name__", None) \
        if getattr(func, "__name__", None) == "__get__" else None


def _check_model(model: torch.nn.Module):
    """Raise SpatialError for a model the spatial path refuses: the int8
    model, or one in train mode."""
    if any(isinstance(m, (Int8Conv2d, Int8Handoff, Int8RepBlock)) for m in model.modules()):
        raise SpatialError("the int8 model has no spatial path: XLA cannot partition a "
                           "pallas_call, so the JAX package has none either")
    if model.training or model.detect.training:
        raise SpatialError("the spatial path runs inference only: the model is in train mode "
                           "(BN's batch statistics would be per band; no JAX entry point trains "
                           "on a spatial mesh). Call model.eval()")


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class BandThreads:
    """One long-lived thread a band. cuDNN keeps its execution plans per
    thread (PyTorch's cache of them is thread-local), so threads made anew
    for each forward would plan every conv again. `run(jobs)` runs jobs[k]
    on thread k and waits for all; `close()` ends the threads."""

    def __init__(self, n: int):
        self._queues = [queue.SimpleQueue() for _ in range(n)]
        self._threads = [threading.Thread(target=self._serve, args=(q,), daemon=True,
                                          name=f"spatial-band-{k}")
                         for k, q in enumerate(self._queues)]
        for t in self._threads:
            t.start()

    def __len__(self):
        return len(self._threads)

    @staticmethod
    def _serve(q):
        while (job := q.get()) is not None:
            job()

    def run(self, jobs: Sequence[Callable[[], None]]):
        """Run jobs[k] on thread k, all at once; a job must not raise."""
        done = [threading.Event() for _ in jobs]

        def wrap(job, ev):
            try:
                job()
            finally:
                ev.set()

        for q, job, ev in zip(self._queues, jobs, done):
            q.put(functools.partial(wrap, job, ev))
        for ev in done:
            ev.wait()

    def close(self):
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join()


def run_banded(fn: Callable, bands: List[List[torch.Tensor]], blocks: List[List[tuple]],
               threads: BandThreads):
    """Run fn(i, j, bands[i][j]) for every band of a grid in lock step, each
    on a thread of its own (`threads`, one a band in row-major order), in
    inference mode on the band's device,
    under the halo mode: the bands of row i meet at its exchanges, where
    blocks[i][j] is band (i, j)'s [start, stop) rows at the coarsest level
    (a band's NCHW maps then hold a whole multiple of stop - start rows). A
    band that raises aborts its row's exchange, so that the others stop at
    their next one; the first error that is not a broken barrier is raised
    here. Returns (the grid of fn's results, the halo rows and bytes
    taken)."""
    out = [[None] * len(row) for row in bands]
    modes = [[_BandMode(ex, j) for j in range(len(row))]
             for row, ex in zip(bands, (_Exchange(b) for b in blocks))]
    errors = []

    def band(i, j):
        mode = modes[i][j]
        try:
            with torch.inference_mode(), _on(bands[i][j].device), mode:
                out[i][j] = fn(i, j, bands[i][j])
        except BaseException as e:  # noqa: BLE001  (re-raised in the caller's thread)
            errors.append(e)
            mode.ex.barrier.abort()

    jobs = [functools.partial(band, i, j) for i, row in enumerate(bands) for j in range(len(row))]
    if len(threads) != len(jobs):
        raise ValueError(f"{len(jobs)} bands for {len(threads)} threads")
    threads.run(jobs)
    if errors:
        raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    flat = [m for row in modes for m in row]
    return out, {"rows": sum(m.halo_rows for m in flat), "bytes": sum(m.halo_bytes for m in flat)}


class SpatialBands:
    """A model's replicas on a (data, spatial) mesh (one a distinct device,
    in `dtype`, channels_last on a card) and the lock-step run of its bands.
    `halo` holds the last run's halo rows and bytes (a row spans a band's
    batch chunk, channels and width). Its band threads live until `close()`
    (or until it is collected)."""

    def __init__(self, model: torch.nn.Module, mesh: Sequence[Sequence],
                 dtype: Optional[torch.dtype] = None):
        _check_model(model)
        self.grid = [[torch.device(d) for d in row] for row in mesh]
        if not self.grid or not self.grid[0] or len({len(r) for r in self.grid}) != 1:
            raise ValueError("a (data, spatial) mesh is a non-empty grid of devices")
        self.stride = max(model.detect.strides)
        self.dtype = dtype or model_device_dtype(model)[1]
        devices = list(dict.fromkeys(d for row in self.grid for d in row))
        self.replicas = dict(zip(devices, replicate(model, devices, self.dtype)))
        self.halo = {"rows": 0, "bytes": 0}
        self.threads = BandThreads(sum(len(row) for row in self.grid))
        self.close = weakref.finalize(self, self.threads.close)

    def decodes(self, pieces: List[List[torch.Tensor]],
                prep: Callable[[torch.Tensor, torch.dtype], torch.Tensor]) -> List[torch.Tensor]:
        """The grid of (b, h_j, W, C) bands -> each data row's (b, A, 290)
        decode, on the row's first device. `prep` turns a band into the
        forward's NCHW input in the compute dtype."""
        if len(pieces) != len(self.grid) or any(len(p) != len(r)
                                                for p, r in zip(pieces, self.grid)):
            raise ValueError(f"a grid of bands shaped {[len(p) for p in pieces]} for a mesh "
                             f"of {len(self.grid)} x {len(self.grid[0])}")
        xs = []
        with torch.inference_mode():
            for row, devs in zip(pieces, self.grid):
                for p, dev in zip(row, devs):
                    if p.device != dev:
                        raise ValueError(f"a band on {p.device} where the mesh has {dev}")
                xs.append([prep(p, self.dtype) for p in row])

        def pred_maps(i, j, x):
            rep = self.replicas[x.device]
            return rep.detect.pred_maps(rep.neck(rep.backbone(x)))[1]

        maps, halo = run_banded(pred_maps, xs, [self._blocks(row) for row in pieces],
                                self.threads)
        self.halo.update(halo)
        out = []
        for i, row in enumerate(maps):
            dev = self.grid[i][0]
            levels = [tuple(torch.cat([band[lv][k].to(dev, non_blocking=True) for band in row], 2)
                            for k in range(2)) for lv in range(len(row[0]))]
            out.append(self.replicas[dev].detect.decode(levels))
        return out

    def _blocks(self, row):
        """Each band's [start, stop) rows at the coarsest level."""
        stops = [0]
        for p in row:
            if p.shape[1] % self.stride or p.shape[1] == 0:
                raise SpatialError(f"a band of {p.shape[1]} rows: bands are cut on whole blocks "
                                   f"of {self.stride} rows (image_sharding(mesh, {self.stride}))")
            stops.append(stops[-1] + p.shape[1] // self.stride)
        return list(zip(stops[:-1], stops[1:]))


def _float_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).to(dtype)


def _pixels_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return unit_pixels(x.permute(0, 3, 1, 2), dtype)


def spatial_forward(model: torch.nn.Module, mesh: Sequence[Sequence]):
    """fn(x) -> the (B, A, 290) eval decode of `model` on mesh[0][0], its
    bands run over `mesh` (a grid from parallel/mesh.py:data_spatial_mesh):
    the counterpart of the JAX test's jitted forward with `image_sharding`
    in and a replicated decode out. `x` is a (B, H, W, C) float batch, or the
    grid of bands that `fn.put` (image_sharding at the model's coarsest
    stride) staged. The replicas compute in the model's dtype. `fn.halo`
    holds the last call's halo rows and bytes; `fn.close()` ends the band
    threads."""
    bands = SpatialBands(model, mesh)
    sharding = image_sharding(bands.grid, bands.stride)

    def fn(x):
        pieces = x if isinstance(x, list) else sharding.put(x)
        with torch.inference_mode():
            first = bands.grid[0][0]
            return torch.cat([d.to(first, non_blocking=True)
                              for d in bands.decodes(pieces, _float_nchw)])

    fn.put, fn.halo, fn.bands, fn.close = sharding.put, bands.halo, bands, bands.close
    return fn


def make_spatial_infer_fn(model: torch.nn.Module, mesh: Sequence[Sequence],
                          conf_thres: float = 0.03, iou_thres: float = 0.65, max_det: int = 300,
                          pre_nms_topk: int = 512, dtype: Optional[torch.dtype] = None,
                          candidate_selector: str = "topk"):
    """(run, put) for `model` (the fused deploy model, or the train graph in
    eval mode) over a (data, spatial) `mesh`, as
    parallel/infer.py:make_sharded_infer_fn gives them for a data mesh.

    run(images_u8) -> (det, valid, num) of the whole (B, H, W, 3) uint8
    batch, in batch order, on mesh[0][0]; B must split over the mesh's rows.
    `images_u8` is a host array or tensor, or the bands `put` staged. Each
    data row's decode is gathered onto the row's first device and goes
    through ops/nms.py there: one greedy-NMS launch a data row a batch.
    `dtype` is the compute dtype (default: the model's). `run.halo` holds
    the last call's halo rows and bytes, `run.bands` the replicas;
    `run.close()` ends the band threads."""
    bands = SpatialBands(model, mesh, dtype)
    put = image_sharding(bands.grid, bands.stride).put

    @torch.inference_mode()
    def run(images_u8):
        pieces = images_u8 if isinstance(images_u8, list) else put(images_u8)
        outs = [non_max_suppression(pred, conf_thres=conf_thres, iou_thres=iou_thres,
                                    max_det=max_det, pre_nms_topk=pre_nms_topk,
                                    candidate_selector=candidate_selector)
                for pred in bands.decodes(pieces, _pixels_nchw)]
        first = bands.grid[0][0]
        return tuple(torch.cat([o[k].to(first, non_blocking=True) for o in outs])
                     for k in range(3))

    run.halo, run.bands, run.close = bands.halo, bands, bands.close
    return run, put

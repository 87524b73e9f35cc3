"""Process groups, data meshes and the collectives of data-parallel training
(counterpart of yololp_tpu/parallel/mesh.py).

The JAX package runs one program on the global batch over a 1-D 'data'
mesh and lets XLA partition it. Here there is one process per card, started
by torchrun (`python -m torch.distributed.run`) or spawned by
`tools.train --data-parallel`, joined by `torch.distributed`:

  * `initialize_distributed` joins the group as the JAX function does
    (a coordinator's address, the number of processes and this process's
    id, as arguments or as COORDINATOR_ADDRESS, NUM_PROCESSES and
    PROCESS_ID), or from torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT), which comes before the JAX
    variables, with NCCL for cards and gloo for the CPU unless the caller
    names a backend;
  * `DistributedDataParallel` averages the gradients, and each rank's loss
    is its share of the global loss times the world size, so the update is
    the global batch's (core/train_step.py);
  * the loss's denominators (`global_sum`) and BN's batch statistics
    (`global_sum_grad`, layers/blocks.py) are summed over the ranks, as the
    partitioned JAX program sums them over the global batch;
  * `shard_dataset_indices` and `process_shard` (data/datasets.py) give each
    rank its slice of the data; rank 0 alone evaluates, checkpoints and
    logs (`is_main_process`), and `barrier` holds the others meanwhile.

The JAX package's 2-D (data, spatial) mesh has its counterpart here too:
`data_spatial_mesh` is a grid of devices in one process, and the shardings
(`image_sharding`, `data_sharding`, `replicated`) place a (B, H, W, C) batch
on it; parallel/spatial.py runs the height-sharded forward over such a grid.

Outside a process group (or in one of one rank) every function here is the
single-process identity.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from yololp_tpu_torch.utils.device import resolve_device


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if _active() else 1


def rank() -> int:
    return dist.get_rank() if _active() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def is_main_process() -> bool:
    return rank() == 0


JAX_VARS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


def jax_rendezvous(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> Optional[Tuple[str, int, int]]:
    """The JAX package's rendezvous, (coordinator "host:port", number of
    processes, process id), from the arguments or else COORDINATOR_ADDRESS,
    NUM_PROCESSES (default 1) and PROCESS_ID (default 0); None without a
    coordinator. The precedence is the JAX function's `arg or env`, its
    quirk included: an explicit process_id=0 (or num_processes=0) is falsy
    and so yields to the environment."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is None:
        return None
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r}: expected 'host:port'")
    return (coordinator, num_processes or int(os.environ.get("NUM_PROCESSES", 1)),
            process_id or int(os.environ.get("PROCESS_ID", 0)))


def initialize_distributed(backend: Optional[str] = None,
                           timeout: Optional[datetime.timedelta] = None, *,
                           coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Join a process group; returns whether this process is in one (a
    no-op returning True when the group is already joined).

    Three rendezvous, tried in this order:
      * a `coordinator` argument: the JAX package's rendezvous
        (`jax_rendezvous`) over tcp://<coordinator>;
      * torchrun's per-process RANK, WORLD_SIZE, MASTER_ADDR and
        MASTER_PORT over env://, whenever WORLD_SIZE is set, so that a
        host-wide COORDINATOR_ADDRESS does not give every rank one id;
      * COORDINATOR_ADDRESS with NUM_PROCESSES and PROCESS_ID, as the JAX
        CLIs are launched, over tcp://<coordinator>.
    With none of them, the call is a no-op returning False (single process).

    One process drives one card here, so NUM_PROCESSES counts processes,
    that is cards, where in JAX it counts hosts (one process drives all of
    its host's chips). `tools.train` maps a launch of one process a host onto
    one process a card (it spawns them); a caller of this function on a
    host of several cards starts one process per card itself.

    `backend`: "nccl" or "gloo"; None takes NCCL when a card is present and
    gloo otherwise. A backend is never switched: NCCL without a card raises.
    With NCCL each process takes the card of its LOCAL_RANK (torchrun sets
    it), else of its rank modulo the visible cards. JAX's three arguments
    are keywords here: a positional argument is the backend."""
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo' (a coordinator is the "
                         "keyword argument coordinator=)")
    if _active():
        return True
    tcp = None if coordinator is None and "WORLD_SIZE" in os.environ else \
        jax_rendezvous(coordinator, num_processes, process_id)
    if tcp is not None:
        coordinator, world, proc = tcp
        init = {"init_method": f"tcp://{coordinator}", "world_size": world, "rank": proc}
    elif "WORLD_SIZE" in os.environ:
        init = {"init_method": "env://"}
        proc = int(os.environ.get("RANK", 0))
    else:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs a CUDA card; name backend='gloo' "
                               "for ranks on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", proc % torch.cuda.device_count())))
    if timeout is not None:
        init["timeout"] = timeout
    dist.init_process_group(backend=backend, **init)
    return True


def barrier():
    """Wait for every rank (no-op at world size 1)."""
    if world_size() <= 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def data_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The 1-D data mesh: under a process group of more than one rank, one
    entry per rank (the card of each rank, one card a rank); else the local
    cards, the first `n_devices` of them."""
    if world_size() > 1:
        n_local = max(torch.cuda.device_count(), 1)
        kind = "cuda" if torch.cuda.is_available() else "cpu"
        return [torch.device(kind, r % n_local) if kind == "cuda" else torch.device("cpu")
                for r in range(world_size())]
    n = torch.cuda.device_count() if n_devices is None else n_devices
    return [torch.device("cuda", i) for i in range(n)]


def data_spatial_mesh(n_data: int, n_spatial: int, device="cuda",
                      share: bool = False) -> List[List[torch.device]]:
    """The (data, spatial) mesh: an `n_data` x `n_spatial` grid of devices,
    row-major over the visible cards, as the JAX mesh reshapes
    `jax.devices()[:n_data * n_spatial]`. The batch splits over the rows and
    the image height over the columns (`image_sharding`). Asked for more
    entries than there are visible cards it raises, unless `share` lets the
    entries wrap round them (on one card every entry is then cuda:0).
    device='cpu' (or 'meta') gives a grid of that one device."""
    if n_data < 1 or n_spatial < 1:
        raise ValueError(f"a ({n_data}, {n_spatial}) mesh")
    dev = resolve_device(device)
    n = n_data * n_spatial
    if dev.type != "cuda":
        flat = [dev] * n
    else:
        visible = torch.cuda.device_count()
        if n > visible and not share:
            raise RuntimeError(f"a ({n_data}, {n_spatial}) mesh needs {n} cards, found {visible} "
                               "visible; pass share=True to put several entries on one card")
        flat = [torch.device("cuda", i % visible) for i in range(n)]
    return [flat[i * n_spatial:(i + 1) * n_spatial] for i in range(n_data)]


def band_rows(height: int, n_bands: int, stride: int = 1) -> List[Tuple[int, int]]:
    """The [start, stop) rows of `n_bands` bands of an image `height` rows
    tall, cut on whole blocks of `stride` rows: the height // stride blocks
    split as evenly as they go, the first bands taking one more (5 blocks
    over 4 bands: 2, 1, 1, 1). Raises where the blocks are fewer than the
    bands."""
    if height % stride:
        raise ValueError(f"a height of {height} rows is not a multiple of the stride {stride}")
    blocks = height // stride
    if not 1 <= n_bands <= blocks:
        raise ValueError(f"{n_bands} bands of an image of {blocks} rows at stride {stride}: "
                         "a band needs at least one row")
    q, r = divmod(blocks, n_bands)
    stops = np.cumsum([0] + [q + (j < r) for j in range(n_bands)]) * stride
    return [(int(a), int(b)) for a, b in zip(stops[:-1], stops[1:])]


class Sharding:
    """Where the pieces of a (B, H, W, C) array lie on a mesh: a grid from
    `data_spatial_mesh`, or a list of devices (`data_mesh`), read as a
    column of one-device rows. With `batch` the batch splits over the rows
    in order, with `height` the rows of the image over the columns in bands
    (`band_rows` at `stride`); an axis not split is replicated along it.

    put(x) gives the pieces on their devices, nested as the mesh is (each
    contiguous, copied without a host synchronisation); gather(pieces)
    reassembles the array on the mesh's first device."""

    def __init__(self, mesh: Sequence, batch: bool, height: bool, stride: int = 1):
        self.nested = isinstance(mesh[0], (list, tuple))
        self.grid = [list(r) for r in mesh] if self.nested else [[d] for d in mesh]
        self.batch, self.height, self.stride = batch, height, stride

    def put(self, x) -> list:
        x = torch.as_tensor(x)
        n_rows, n_cols = len(self.grid), len(self.grid[0])
        if self.batch and x.shape[0] % n_rows:
            raise ValueError(f"batch {x.shape[0]} does not split over {n_rows} mesh rows")
        chunks = x.tensor_split(n_rows) if self.batch else [x] * n_rows
        rows = []
        for row, chunk in zip(self.grid, chunks):
            bands = ([chunk[:, a:b] for a, b in band_rows(x.shape[1], n_cols, self.stride)]
                     if self.height else [chunk] * n_cols)
            rows.append([p.contiguous().to(d, non_blocking=True) for p, d in zip(bands, row)])
        return rows if self.nested else [r[0] for r in rows]

    def gather(self, pieces: list) -> torch.Tensor:
        rows = pieces if self.nested else [[p] for p in pieces]
        first = self.grid[0][0]
        wholes = [torch.cat([p.to(first) for p in row], 1) if self.height else row[0].to(first)
                  for row in rows]
        return torch.cat(wholes, 0) if self.batch else wholes[0]


def image_sharding(mesh: Sequence, stride: int = 32) -> Sharding:
    """(B, H, W, C) images: the batch over the mesh's rows, the height over
    its columns in bands of whole `stride`-row blocks (the model's coarsest
    stride: 32, or 64 with a 4-level head)."""
    return Sharding(mesh, batch=True, height=True, stride=stride)


def data_sharding(mesh: Sequence) -> Sharding:
    """The batch over the mesh's rows, each chunk whole on every device of its row."""
    return Sharding(mesh, batch=True, height=False)


def replicated(mesh: Sequence) -> Sharding:
    """The whole array on every device of the mesh."""
    return Sharding(mesh, batch=False, height=False)


def shard_dataset_indices(n_items: int, shuffle_seed: int = 0, epoch: int = 0,
                          rank: Optional[int] = None, world: Optional[int] = None) -> np.ndarray:
    """This rank's slice of the epoch's shuffle: the permutation seeded by
    `shuffle_seed + epoch` (the JAX function's generator), sliced
    [rank::world] (the process group's unless given)."""
    r = (dist.get_rank() if _active() else 0) if rank is None else rank
    w = world_size() if world is None else world
    idxs = np.random.default_rng(shuffle_seed + epoch).permutation(n_items)
    return idxs[r::w]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, without gradient (the loss's
    denominators come from the assigner's targets, which carry none)."""
    if world_size() <= 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


class _SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) whose backward is all_reduce(SUM) of the gradient:
    each rank's input feeds every rank's output."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def global_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, with the gradient flowing back to every
    rank's input."""
    if world_size() <= 1:
        return t
    return _SumOverRanks.apply(t)


def broadcast_(tensors: List[torch.Tensor], src: int = 0):
    """Overwrite `tensors` in place with rank `src`'s (no-op at world 1)."""
    if world_size() <= 1:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src)

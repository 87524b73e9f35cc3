"""Process groups, data meshes and the collectives of data-parallel training
(counterpart of yololp_tpu/parallel/mesh.py).

The JAX package runs one program on the global batch over a 1-D 'data'
mesh and lets XLA partition it. Here there is one process per card, started
by torchrun (`python -m torch.distributed.run`) or spawned by
`tools.train --data-parallel`, joined by `torch.distributed`:

  * `initialize_distributed` joins the group from torchrun's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), with NCCL for
    cards and gloo for the CPU unless the caller names a backend;
  * `DistributedDataParallel` averages the gradients, and each rank's loss
    is its share of the global loss times the world size, so the update is
    the global batch's (core/train_step.py);
  * the loss's denominators (`global_sum`) and BN's batch statistics
    (`global_sum_grad`, layers/blocks.py) are summed over the ranks, as the
    partitioned JAX program sums them over the global batch;
  * `shard_dataset_indices` and `process_shard` (data/datasets.py) give each
    rank its slice of the data; rank 0 alone evaluates, checkpoints and
    logs (`is_main_process`), and `barrier` holds the others meanwhile.

Outside a process group (or in one of one rank) every function here is the
single-process identity.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist


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


def initialize_distributed(backend: Optional[str] = None,
                           timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join the process group torchrun describes (env:// rendezvous). A
    no-op without WORLD_SIZE in the environment, or when the group is
    already joined; returns whether this process is in a group.

    The JAX package's variables map as COORDINATOR_ADDRESS ->
    MASTER_ADDR:MASTER_PORT, NUM_PROCESSES -> WORLD_SIZE, PROCESS_ID ->
    RANK (torchrun sets all of them, and LOCAL_RANK). `backend`: "nccl" or
    "gloo"; None takes NCCL when a card is present and gloo otherwise. A
    backend is never switched: NCCL without a card raises. With NCCL each
    rank takes the card of its LOCAL_RANK."""
    if _active():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs a CUDA card; name backend='gloo' "
                               "for ranks on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0))))
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend=backend, init_method="env://", **kw)
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

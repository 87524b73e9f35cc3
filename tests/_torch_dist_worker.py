"""One rank of the port's data-parallel CPU tests (tests/test_torch_ddp.py),
and the launcher that starts the ranks.

    python tests/_torch_dist_worker.py <case> <input.pt> <output prefix>

with torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
set by `run_ranks`. The rank joins a gloo group with a short timeout, runs
the case on its shard of the global batch the input file holds, and saves
what the test compares to `<output prefix>.<rank>.pt`. Imports torch and
the port only (no JAX).
"""

import datetime
import os
import socket
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def wait_all(procs, timeout: float, what: str):
    """communicate() with each process within `timeout` seconds; on a
    timeout every process is killed and the test fails with their output."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [p.communicate()[0][-3000:] for p in procs]
        raise AssertionError(f"{what}: a rank hung past {timeout} s\n" + "\n---\n".join(tails))
    for i, (p, (out, _)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{what}: rank {i} exited {p.returncode}\n{out[-4000:]}"
    return [o for o, _ in outs]


class Ranks:
    """`world` ranks running `case` in the background: start them, do other
    work, then `results(timeout)` waits for them (and kills them all past
    the timeout) and returns each rank's saved output."""

    def __init__(self, case: str, inputs: dict, tmp_path, world: int = 2):
        src = os.path.join(str(tmp_path), f"{case}_in.pt")
        torch.save(inputs, src)
        self.case, self.world = case, world
        self.prefix = os.path.join(str(tmp_path), f"{case}_out")
        port = free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, src, self.prefix],
            env=rank_env(r, world, port), cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def results(self, timeout: float = 120):
        wait_all(self.procs, timeout, self.case)
        return [torch.load(f"{self.prefix}.{r}.pt", weights_only=False)
                for r in range(self.world)]


def run_ranks(case: str, inputs: dict, tmp_path, world: int = 2, timeout: float = 120):
    """Run `case` on `world` ranks; returns each rank's saved output."""
    return Ranks(case, inputs, tmp_path, world).results(timeout)


def shard(x, rank: int, world: int):
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


# ---------------- the cases: each runs on one rank's shard ----------------


def case_bn(inp, rank, world):
    from yololp_tpu_torch.layers.blocks import batch_norm

    bn = batch_norm(inp["x"].shape[1]).double()
    bn.load_state_dict(inp["bn"])
    bn.train()
    x = shard(inp["x"], rank, world).clone().requires_grad_()
    y = bn(x)
    (y * shard(inp["g"], rank, world)).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad, "w_grad": bn.weight.grad, "b_grad": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def case_loss(inp, rank, world):
    from yololp_tpu_torch.losses.distill import distill_loss
    from yololp_tpu_torch.losses.loss import compute_loss
    from yololp_tpu_torch.models.effidehead import HeadTrainOutput

    preds = HeadTrainOutput(None, *(shard(t, rank, world).clone().requires_grad_()
                                    for t in inp["preds"]))
    teacher = HeadTrainOutput(None, *(shard(t, rank, world) for t in inp["teacher"]))
    total, items, fg = compute_loss(preds, shard(inp["labels"], rank, world),
                                    shard(inp["mask"], rank, world), inp["cfg"], with_fg=True)
    cls_kd, dfl_kd = distill_loss(preds, teacher, fg, use_dfl=True, reg_max=inp["cfg"].reg_max)
    (total + cls_kd + dfl_kd).backward()
    return {"total": total.detach(), "items": items, "kd": torch.stack([cls_kd, dfl_kd]).detach(),
            "grads": [t.grad for t in preds[1:]]}


def train_model(inp):
    from yololp_tpu_torch.models.yolo import Model
    from yololp_tpu_torch.utils.config import Config
    from yololp_tpu_torch.utils.convert import load_state_dict_strict

    model = Model(Config.named(inp["config"])).double()
    load_state_dict_strict(model, inp["state_dict"])
    return model


def _snapshot(state):
    return {"params": [p.detach().clone() for p in state.params],
            "stats": [b.clone() for b in state.batch_stats],
            "ema": [e.clone() for e in state.ema_params + state.ema_stats],
            "momentum": [m.clone() for m in state.momentum],
            "grads": [g.clone() for g in state.grad_accum],
            "counts": (state.ema_updates, state.step, state.last_opt_step)}


def run_steps(inp, rank, world):
    """For each start (step, last_opt_step) of inp['starts']: the state,
    the totals and items of each of the batches' steps, from inp's weights
    on this rank's shard of each global batch (world 1: the whole batch)."""
    from yololp_tpu_torch.core.train_step import init_train_state, make_train_step

    runs = []
    for start in inp["starts"]:
        model = train_model(inp)
        state = init_train_state(model)
        state.step, state.last_opt_step = start
        step_fn = make_train_step(model, inp["loss_cfg"], inp["solver_cfg"], inp["batch_size"],
                                  dtype=torch.float64)
        steps = []
        for imgs, labels, mask in inp["batches"]:
            state, total, items = step_fn(state, shard(imgs, rank, world),
                                          shard(labels, rank, world), shard(mask, rank, world))
            steps.append({"total": total, "items": items, **_snapshot(state)})
        runs.append(steps)
    return runs


def case_train(inp, rank, world):
    return {"runs": run_steps(inp, rank, world), "cache": cached_epoch(inp, rank, world)}


def cached_epoch(inp, rank, world):
    """One --cache-device epoch (the Trainer's path: the whole set staged,
    each rank gathering its block of every row of the global index
    matrix); returns the epoch's summed loss items and the state after."""
    from yololp_tpu_torch.core.train_step import init_train_state, make_train_step
    from yololp_tpu_torch.data.datasets import TrainValDataset
    from yololp_tpu_torch.data.device_cache import DeviceCachedData, make_cached_epoch

    cache = DeviceCachedData(TrainValDataset(inp["train_dir"], img_size=inp["img_size"],
                                             augment=False), seed=0, device="cpu")
    model = train_model(inp)
    state = init_train_state(model)
    step_fn = make_train_step(model, inp["loss_cfg"], inp["solver_cfg"], inp["batch_size"],
                              dtype=torch.float64)
    epoch_fn = make_cached_epoch(step_fn, cache.img_shape,
                                 (rank, world) if world > 1 else None)
    idx = cache.epoch_index_matrix(inp["batch_size"], 0)
    state, items = epoch_fn(state, cache.images, cache.labels, cache.masks, torch.from_numpy(idx))
    return {"items_sum": items, "steps": len(idx), **_snapshot(state)}


def main():
    import torch.distributed as dist

    from yololp_tpu_torch.parallel.mesh import initialize_distributed, rank, world_size

    torch.set_num_threads(1)  # two ranks beside the test process and other test files
    case, src, prefix = sys.argv[1:4]
    initialize_distributed("gloo", timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    inp = torch.load(src, weights_only=False)
    out = globals()[f"case_{case}"](inp, rank(), world_size())
    torch.save(out, f"{prefix}.{rank()}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()

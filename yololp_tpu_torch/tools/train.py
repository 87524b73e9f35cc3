"""Training CLI (mirrors tools/train.py of the JAX package).

Examples:
  python -m yololp_tpu_torch.tools.train --conf-file yololps --data-path data/dataset.yaml
  python -m yololp_tpu_torch.tools.train --conf-file yololpn --synthetic-data --epochs 2 \\
      --img-size 64 --batch-size 4 --device cpu     # smoke run, no dataset
  # RepOpt: hyper-search, then the RealVGG net from its scales (a config
  # whose `scales` names the hyper-search checkpoint or a scales file)
  python -m yololp_tpu_torch.tools.train --conf-file repopt/yolov6n_hs ...
  python -m yololp_tpu_torch.tools.train --conf-file my_yolov6n_opt.py ...
  # distillation from a teacher checkpoint
  python -m yololp_tpu_torch.tools.train --conf-file yololpn --distill \\
      --teacher-ckpt runs/train/yololps/weights/best_ckpt.msgpack --teacher-conf yololps ...

  # data-parallel: one process per card, --batch-size is the global batch
  torchrun --nproc_per_node 4 -m yololp_tpu_torch.tools.train --conf-file yololps ...
  python -m yololp_tpu_torch.tools.train --conf-file yololps ...  # spawns one rank per card

  # launched as the JAX CLI is: one process a host, here host 1 of 2; with
  # more than one card, each host spawns one rank per card (every host must
  # see as many cards)
  COORDINATOR_ADDRESS=host0:29500 NUM_PROCESSES=2 PROCESS_ID=1 \\
      python -m yololp_tpu_torch.tools.train --conf-file yololps ...

`--device cuda` (the default) or `cpu`. Under torchrun (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT in the environment) each process joins
the group (NCCL on cards, gloo with --device cpu) and takes the card of its
LOCAL_RANK; without torchrun, --data-parallel (the default) with more than
one visible card spawns one process per card. Rank 0 writes the synthetic
set, the checkpoints and the log. Writes last/best checkpoints and
final_ckpt.msgpack under <output-dir>/<name>/weights in the JAX package's
msgpack format (either package loads them).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import socket
import sys


def get_args_parser():
    p = argparse.ArgumentParser("YOLO-LP training (PyTorch/CUDA)", add_help=True)
    p.add_argument("--data-path", type=str, default=None, help="dataset yaml")
    p.add_argument("--conf-file", type=str, default="yololps",
                   help="model config: built-in name or .py path")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    p.add_argument("--eval-interval", type=int, default=20)
    p.add_argument("--heavy-eval-range", type=int, default=50,
                   help="eval every epoch in the last N epochs")
    p.add_argument("--stop_aug_last_n_epoch", type=int, default=15)
    p.add_argument("--save_ckpt_on_last_n_epoch", type=int, default=0)
    p.add_argument("--save-every-epoch", action="store_true",
                   help="save last_ckpt every epoch (default: eval epochs only)")
    p.add_argument("--output-dir", default="./runs/train")
    p.add_argument("--name", default="exp")
    p.add_argument("--resume", nargs="?", const=True, default=False)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--approx-topk", action="store_true",
                   help="the assigners' approx_max_k selection: the exact top-k (a stable "
                        "sort), which is what XLA computes for it off the TPU")
    p.add_argument("--assigner", choices=["atss", "tal", "atss_tal"], default=None,
                   help="override the label assigner: atss, tal, or atss_tal (ATSS "
                        "warmup epochs, then task-aligned)")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--fp32", dest="bf16", action="store_false")
    p.add_argument("--data-parallel", action="store_true", default=True,
                   help="with more than one visible card, no torchrun environment and "
                        "--device cuda, spawn one process per card (the batch is split "
                        "over them; launched as the JAX CLI is, one process a host, each "
                        "host spawns its cards' ranks, and every host must see as many "
                        "cards); --device cuda:N trains on card N alone")
    p.add_argument("--cache-device", action="store_true",
                   help="stage the whole dataset on the device and gather batches there "
                        "(no-augmentation runs only)")
    p.add_argument("--epochs-per-dispatch", type=int, default=1,
                   help="with --cache-device: run up to K consecutive epochs in one call "
                        "(chunks break at eval/ckpt epochs and assigner switches)")
    p.add_argument("--synthetic-data", action="store_true",
                   help="generate a small synthetic dataset (smoke/demo)")
    p.add_argument("--synthetic-n", type=int, default=64)
    p.add_argument("--quant", action="store_true",
                   help="QAT training (requires a calib amax file)")
    p.add_argument("--calib", action="store_true",
                   help="with --quant: run PTQ calibration then exit")
    p.add_argument("--calib-pt", type=str, default=None,
                   help="calibration amax json for QAT (overrides cfg.qat)")
    p.add_argument("--distill", action="store_true",
                   help="LP knowledge distillation from --teacher-ckpt")
    p.add_argument("--teacher-ckpt", type=str, default=None,
                   help="teacher checkpoint (either package's msgpack)")
    p.add_argument("--teacher-conf", type=str, default=None,
                   help="teacher config (default: --conf-file)")
    return p


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned_rank(i: int, argv, first_rank: int, world: int, addr: str, port: int):
    """Rank first_rank + i of a --data-parallel spawn, on card i of its host:
    torchrun's environment in place of the JAX variables, then main."""
    from yololp_tpu_torch.parallel.mesh import JAX_VARS

    for k in JAX_VARS:
        os.environ.pop(k, None)
    os.environ.update(RANK=str(first_rank + i), LOCAL_RANK=str(i), WORLD_SIZE=str(world),
                      MASTER_ADDR=addr, MASTER_PORT=str(port))
    main(argv)


def main(args=None):
    parser = get_args_parser()
    argv = list(sys.argv[1:] if args is None else args)
    args = parser.parse_args(argv)
    if not (args.synthetic_data or args.data_path):
        parser.error("--data-path or --synthetic-data required")
    import torch

    from yololp_tpu_torch.parallel.mesh import barrier, initialize_distributed, jax_rendezvous
    from yololp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)  # no card and not --device cpu: raise before any work
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if (args.data_parallel and "WORLD_SIZE" not in os.environ and dev.type == "cuda"
            and dev.index is None and n_cards > 1):
        # one process a card. Launched as the JAX CLI is (COORDINATOR_ADDRESS,
        # NUM_PROCESSES hosts, this host's PROCESS_ID), host h's cards are the
        # ranks h * n_cards + i of NUM_PROCESSES * n_cards, met at the coordinator
        rdv = jax_rendezvous()
        if rdv is None:
            addr, port, hosts, host = "localhost", _free_port(), 1, 0
        else:
            coordinator, hosts, host = rdv
            addr, _, port = coordinator.rpartition(":")
        world = hosts * n_cards
        if args.batch_size % world:
            parser.error(f"{world} cards must divide the global --batch-size {args.batch_size}")
        torch.multiprocessing.spawn(_spawned_rank,
                                    args=(argv, host * n_cards, world, addr, int(port)),
                                    nprocs=n_cards)
        return None
    # under torchrun, or launched as the JAX CLI is on one card or the CPU:
    # join the group before anything else; with NCCL the group's join has set
    # this process's card
    joined = initialize_distributed("gloo" if dev.type == "cpu" else "nccl")
    if joined and dev.type == "cuda" and dev.index is None:
        args.device = f"cuda:{torch.cuda.current_device()}"
    try:
        best = _train(args)
        barrier()
        return best
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(args):
    from yololp_tpu_torch.core.engine import Trainer
    from yololp_tpu_torch.data.vocab import load_dataset_yaml
    from yololp_tpu_torch.parallel.mesh import barrier, is_main_process
    from yololp_tpu_torch.utils.config import Config

    cfg = (Config.fromfile(args.conf_file) if args.conf_file.endswith(".py")
           else Config.named(args.conf_file))
    if args.synthetic_data:
        from yololp_tpu_torch.data.synthetic import make_synthetic_dataset

        root = osp.join(args.output_dir, "synthetic_data")
        if is_main_process():
            # one writer: ranks writing the same files would race
            data_dict = make_synthetic_dataset(
                root, n_train=args.synthetic_n, n_val=max(args.synthetic_n // 4, 4),
                img_size=args.img_size, seed=args.seed)
        else:
            data_dict = {"train": osp.join(root, "images", "train"),
                         "val": osp.join(root, "images", "val"),
                         "test": osp.join(root, "images", "val"),
                         "is_coco": False, "npro": 31, "nalp": 24, "nads": 37}
        barrier()
    else:
        data_dict = load_dataset_yaml(args.data_path)
    args.save_dir = osp.join(args.output_dir, args.name)

    trainer = Trainer(args, cfg, data_dict)
    resume_path = None
    if args.resume:
        resume_path = (args.resume if isinstance(args.resume, str)
                       else osp.join(args.save_dir, "weights", "last_ckpt.msgpack"))
    if args.quant and args.calib:
        if resume_path:
            trainer.resume(resume_path)
        return trainer.calibrate()
    best = trainer.train(resume_path=resume_path)
    if is_main_process():
        print(f"Training done. best mAP={best:.4f}. Checkpoints in "
              f"{osp.join(args.save_dir, 'weights')}")
    return best


if __name__ == "__main__":
    main()

"""`python -m yololp_tpu_torch.tools.train --synthetic-data` under torchrun
with 2 gloo ranks on the CPU: one epoch of 2 steps at 64 px (global batch
4, 2 a rank). Rank 0 alone writes the synthetic set, the checkpoints and
train_log.jsonl; the checkpoint loads in the JAX package and in the port.
The run has its own timeout, and the process group a short one, so that a
hang fails the test in seconds rather than at the suite's limit."""

import json
import os
import signal
import subprocess
import sys

import numpy as np

import conftest  # noqa: F401  (forces the JAX cpu backend)
from _torch_dist_worker import ROOT, free_port
from yololp_tpu.utils.checkpoint import load_checkpoint_raw as jax_load_raw
from yololp_tpu_torch.models.yolo import Model
from yololp_tpu_torch.utils.checkpoint import load_checkpoint_raw
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import jax_to_state_dict, load_state_dict_strict

TIMEOUT_S = 150


def test_train_cli_under_torchrun_writes_one_checkpoint(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
           "-m", "yololp_tpu_torch.tools.train", "--device", "cpu", "--synthetic-data",
           "--synthetic-n", "8", "--conf-file", "yololpn", "--img-size", "64",
           "--batch-size", "4", "--epochs", "1", "--workers", "0",
           "--output-dir", str(tmp_path / "runs"), "--name", "exp"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(cmd, cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # torchrun and both ranks
        raise AssertionError(f"tools.train under torchrun hung past {TIMEOUT_S} s:\n"
                             + proc.communicate()[0][-4000:])
    assert proc.returncode == 0, out[-4000:]
    assert out.count("epoch 0:") == 1 and out.count("Training done") == 1, out[-2000:]

    run = tmp_path / "runs" / "exp"
    log = (run / "train_log.jsonl").read_text().splitlines()
    assert len(log) == 1
    record = json.loads(log[0])
    assert record["epoch"] == 0 and record["step"] == 2  # 8 frames, global batch 4
    assert "val/mAP" in record
    weights = sorted(p.name for p in (run / "weights").iterdir())
    assert weights == ["best_ckpt.msgpack", "best_stop_aug_ckpt.msgpack", "final_ckpt.msgpack",
                       "last_ckpt.msgpack"]

    path = str(run / "weights" / "last_ckpt.msgpack")
    ours, theirs = load_checkpoint_raw(path), jax_load_raw(path)
    assert ours["step"] == theirs["step"] == 2
    model = Model(Config.named("yololpn"))
    for tree in (ours["ema"], theirs["ema"]):
        load_state_dict_strict(model, jax_to_state_dict(tree))
    ema = jax_to_state_dict(theirs["ema"])
    for k, v in jax_to_state_dict(ours["ema"]).items():
        np.testing.assert_array_equal(v.numpy(), ema[k].numpy())

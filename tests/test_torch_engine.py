"""Port parity: the trainer's orchestration (core/engine.py), the seven
cases of tests/test_engine.py, and the train CLI end to end on the CPU.

The six orchestration cases stub the train step (a step counter) and the
eval hook (a scripted AP sequence): what they hold is the host-side loop
(resume epoch math, the stop-aug switch, best / best-stop-aug checkpoint
selection, the assigner schedule, the calib checkpoint's epoch). The
epochs-per-dispatch case runs the real step on the device-cache path and
requires the chunked run to equal the per-epoch one record for record and
parameter for parameter (bit for bit: the same operations in the same
order).

The CLI smoke trains yololpn at 64 px on a synthetic set for 2 epochs
(`--workers 0 --synthetic-n 16` to keep it short); the final checkpoint
loads in the JAX package's `load_inference_variables` and in the port's,
and the two deploy forwards agree within the fp32 decode tolerance of
tests/test_torch_models.py.
"""

import json
import os.path as osp
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401
from test_torch_layers import nchw
from test_torch_models import assert_decode_close
from yololp_tpu.models.yolo import Model as JModel
from yololp_tpu.utils import checkpoint as jckpt
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu_torch.core.engine import Trainer
from yololp_tpu_torch.data.synthetic import make_synthetic_dataset
from yololp_tpu_torch.models.yolo import Model
from yololp_tpu_torch.utils import checkpoint as tckpt
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import load_state_dict_strict

torch.set_num_threads(4)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """TensorBoard's import costs seconds and nothing here reads its events."""
    monkeypatch.setattr(Trainer, "_try_tensorboard", lambda self: None)


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("engine_data") / "ds")
    return make_synthetic_dataset(root, n_train=8, n_val=4, img_size=64, seed=3)


def make_args(tmp_path, **over):
    a = types.SimpleNamespace(
        img_size=64, batch_size=4, epochs=3, workers=0, save_dir=str(tmp_path / "run"),
        conf_file="yololpn", seed=0, bf16=False, cache_device=False, assigner="atss",
        stop_aug_last_n_epoch=1, eval_interval=1, heavy_eval_range=0, quant=False,
        calib=False, distill=False, device="cpu")
    for k, v in over.items():
        setattr(a, k, v)
    return a


def make_trainer(tmp_path, tiny_data, **over):
    return Trainer(make_args(tmp_path, **over), Config.named("yololpn"), dict(tiny_data))


def stub_fns(trainer, aps):
    """The step a step counter, the eval hook a scripted AP sequence;
    returns the list of APs handed out."""
    def fake_step(state, imgs, labels, masks):
        state.step += 1
        return state, torch.tensor(0.0), torch.zeros(7)

    trainer._build_train_fns = lambda loss_cfg: (fake_step, None, None)
    trainer._train_fns_cache = {}
    trainer.step_fn, trainer.epoch_fn, trainer.multi_epoch_fn = fake_step, None, None
    calls = []

    def fake_eval():
        ap = aps[len(calls) % len(aps)]
        calls.append(ap)
        return [ap] * 5, {"pre_ms": 0.0, "infer_ms": 0.0, "post_ms": 0.0}

    trainer.eval_model = fake_eval
    return calls


def test_best_ckpt_selection(tmp_path, tiny_data):
    tr = make_trainer(tmp_path, tiny_data, epochs=3, stop_aug_last_n_epoch=1)
    stub_fns(tr, aps=[0.1, 0.5, 0.3])
    assert tr.train() == pytest.approx(0.5)
    wdir = osp.join(tr.save_dir, "weights")
    assert tckpt.load_checkpoint_raw(osp.join(wdir, "best_ckpt.msgpack"))["epoch"] == 1
    assert tckpt.load_checkpoint_raw(osp.join(wdir, "last_ckpt.msgpack"))["epoch"] == 2
    assert tckpt.load_checkpoint_raw(osp.join(wdir, "best_stop_aug_ckpt.msgpack"))["epoch"] == 2
    final = jckpt.load_checkpoint_raw(osp.join(wdir, "final_ckpt.msgpack"))  # flax reads it
    assert final["opt_state"] is None and final["ema"] is None
    log = [json.loads(line) for line in open(tr.log_path)]
    assert [r["epoch"] for r in log] == [0, 1, 2] and [r["step"] for r in log] == [2, 4, 6]


def test_resume_epoch_math(tmp_path, tiny_data):
    tr = make_trainer(tmp_path, tiny_data)
    stub_fns(tr, aps=[0.0])
    tr.state.step, tr.state.ema_updates, tr.state.last_opt_step = 123, 61, 122
    with torch.no_grad():
        tr.state.momentum[0].fill_(0.25)
        tr.state.ema_params[1].fill_(-0.5)
    tr.save("resume_src.msgpack", epoch=5)

    tr2 = make_trainer(tmp_path / "b", tiny_data, epochs=7)
    assert tr2.resume(osp.join(tr.save_dir, "weights", "resume_src.msgpack")) == 6
    assert (tr2.state.step, tr2.state.ema_updates, tr2.state.last_opt_step) == (123, 61, 122)
    assert tr2.resumed_epoch == 5
    for a, b in zip(tr2.state.params + tr2.state.momentum + tr2.state.ema_params,
                    tr.state.params + tr.state.momentum + tr.state.ema_params):
        assert torch.equal(a, b)


def test_resume_past_end_raises(tmp_path, tiny_data):
    tr = make_trainer(tmp_path, tiny_data, epochs=3)
    stub_fns(tr, aps=[0.0])
    tr.save("late.msgpack", epoch=9)
    tr2 = make_trainer(tmp_path / "b", tiny_data, epochs=3)
    stub_fns(tr2, aps=[0.0])
    with pytest.raises(ValueError, match="zero epochs"):
        tr2.train(resume_path=osp.join(tr.save_dir, "weights", "late.msgpack"))


def test_stop_aug_disables_heavy_aug(tmp_path, tiny_data):
    tr = make_trainer(tmp_path, tiny_data, epochs=2, stop_aug_last_n_epoch=1)
    stub_fns(tr, aps=[0.0])
    tr.train_dataset.hyp["mosaic"] = 1.0
    tr.train_dataset.hyp["mixup"] = 0.5
    tr.train()
    assert tr.train_dataset.hyp["mosaic"] == 0.0 and tr.train_dataset.hyp["mixup"] == 0.0


def test_assigner_schedule_switches_fns(tmp_path, tiny_data):
    tr = make_trainer(tmp_path, tiny_data, assigner="atss_tal")
    built = []

    def spy(loss_cfg):
        built.append(loss_cfg.assigner)
        return (lambda s, i, lab, m: (s, torch.tensor(0.0), torch.zeros(7))), None, None

    tr._build_train_fns = spy
    tr._train_fns_cache = {}
    warm = tr.atss_warmup_epoch
    assert warm == 4  # the config's 0 means the upstream default
    for e in (0, warm - 1, warm, warm + 1):
        tr._fns_for_epoch(e)
    assert built == ["atss", "tal"]


def test_calibrate_preserves_source_epoch(tmp_path, tiny_data):
    tr = make_trainer(tmp_path, tiny_data)
    stub_fns(tr, aps=[0.0])
    tr.save("src.msgpack", epoch=7)
    tr2 = make_trainer(tmp_path / "b", tiny_data)
    tr2.resume(osp.join(tr.save_dir, "weights", "src.msgpack"))
    amax = tr2.calibrate()
    wdir = osp.join(tr2.save_dir, "weights")
    assert tckpt.load_checkpoint_raw(osp.join(wdir, "calib_ckpt.msgpack"))["epoch"] == 7
    assert osp.isfile(osp.join(wdir, "calib_amax.json")) and len(amax) > 50
    tr3 = make_trainer(tmp_path / "c", tiny_data)
    tr3.calibrate()
    assert tckpt.load_checkpoint_raw(
        osp.join(tr3.save_dir, "weights", "calib_ckpt.msgpack"))["epoch"] == -1


def test_epochs_per_dispatch_matches_per_epoch(tmp_path, tiny_data):
    def run(sub, epd):
        cfg = Config.named("yololpn")
        cfg["data_aug"] = {k: 0.0 for k in cfg["data_aug"]}
        args = make_args(tmp_path / sub, cache_device=True, epochs=5, eval_interval=3,
                         heavy_eval_range=0, epochs_per_dispatch=epd)
        tr = Trainer(args, cfg, dict(tiny_data))
        evals = []
        tr.eval_model = lambda: (evals.append(True) or
                                 ([0.0] * 5, {"pre_ms": 0.0, "infer_ms": 0.0, "post_ms": 0.0}))
        tr.train()
        return tr, [json.loads(line) for line in open(tr.log_path)], len(evals)

    tr1, log1, ev1 = run("epd1", 1)
    tr4, log4, ev4 = run("epd4", 4)
    assert ev1 == ev4 == 3 and len(log1) == len(log4) == 5  # evals at epochs 0, 3 and 4
    for r1, r4 in zip(log1, log4):
        assert r1["epoch"] == r4["epoch"] and r1["step"] == r4["step"]
        assert {k: v for k, v in r1.items() if k.startswith("train/")} == \
            {k: v for k, v in r4.items() if k.startswith("train/")}
    for a, b in zip(tr1.state.params + tr1.state.ema_params, tr4.state.params + tr4.state.ema_params):
        assert torch.equal(a, b)


def test_train_cli_checkpoint_loads_in_both_packages(tmp_path):
    from yololp_tpu_torch.tools.train import main

    out = tmp_path / "runs"
    main(["--device", "cpu", "--synthetic-data", "--conf-file", "yololpn", "--img-size", "64",
          "--batch-size", "4", "--epochs", "2", "--workers", "0", "--synthetic-n", "16",
          "--output-dir", str(out)])
    final = str(out / "exp" / "weights" / "final_ckpt.msgpack")
    log = [json.loads(line) for line in open(out / "exp" / "train_log.jsonl")]
    assert [r["epoch"] for r in log] == [0, 1] and all(np.isfinite(r["train/cls_loss"]) for r in log)
    jvars = jax.tree_util.tree_map(np.asarray, jckpt.load_inference_variables(final))
    sd = tckpt.load_inference_variables(final)
    x = np.random.default_rng(2).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(JModel(JConfig.named("yololpn"), deploy=True).apply(jvars, jnp.asarray(x)))
    model = load_state_dict_strict(Model(Config.named("yololpn"), deploy=True), sd).eval()
    with torch.no_grad():
        assert_decode_close(model(nchw(x)).numpy(), want)

"""The port's preemption save (mirrors `tests/test_engine.py:131-195`).

SIGTERM, or a set ``preempt_event``, makes ``do_train`` write
``<MODEL.NAME>_preempt.pth`` at the next step boundary and return; its
epoch is the last completed one, so ``--resume`` reruns the interrupted
epoch. Set during the epoch-end eval it is acted on at the epoch boundary.
The checkpoint carries the center-loss centres, and the handler that was
installed before the loop is back after it."""

import os
import signal
import threading

import numpy as np
import pytest
import torch

from signal_tpu_torch import config as tcfg_mod
from signal_tpu_torch.data import make_dataloader
from signal_tpu_torch.engine import train as train_mod
from signal_tpu_torch.models import signal_model as tsm
from signal_tpu_torch.utils.checkpoint import load_checkpoint

from _torch_parity import TRAIN_TINY, tiny_train_cfg

SHRINK = {k: v for k, v in TRAIN_TINY.items() if k not in ("num_classes", "camera_num")}


def _setup(tmp_path, *opts):
    cfg = tiny_train_cfg(tcfg_mod, tmp_path, "MODEL.DEVICE", "cpu",
                         "MODEL.METRIC_LOSS_TYPE", "triplet_center", *opts)
    train_loader, _, val_loader, num_query, num_classes, cams, _ = make_dataloader(cfg)
    spec = tsm.ModelSpec(**dict(TRAIN_TINY, num_classes=num_classes, camera_num=cams))
    return cfg, train_loader, val_loader, num_query, num_classes, spec


def _train(cfg, spec, loaders, **kw):
    train_loader, val_loader, num_query, num_classes = loaders
    return train_mod.do_train(cfg, tsm.init_signal(spec), train_loader, val_loader, num_query,
                              num_classes, device=torch.device("cpu"), **kw)


def _preempt_path(cfg):
    return os.path.join(cfg.OUTPUT_DIR, cfg.ckpt_save_path, f"{cfg.MODEL.NAME}_preempt.pth")


def _saved(path, spec, num_classes, dim):
    centers = torch.zeros(num_classes, dim)
    epoch = load_checkpoint(path, tsm.init_signal(spec), centers=centers)
    return epoch, centers


def test_preemption_checkpoint_and_resume(tmp_path):
    """Set before the first step boundary: the checkpoint records epoch 0
    (epoch 1 reruns from its top) and the centres; a resume from it trains
    epoch 1 to its end."""
    cfg, tl, vl, nq, nc, spec = _setup(tmp_path, "SOLVER.MAX_EPOCHS", "5",
                                       "SOLVER.EVAL_PERIOD", "99", "SOLVER.CHECKPOINT_PERIOD", "99")
    ev = threading.Event()
    ev.set()
    state = _train(cfg, spec, (tl, None, nq, nc), preempt_event=ev)
    path = _preempt_path(cfg)
    assert state.epoch == 0 and os.path.exists(path)
    epoch, centers = _saved(path, spec, nc, 3 * spec.feat_dim)
    assert epoch == 0
    # one step moved the centres, and the checkpoint holds the moved ones
    assert torch.equal(centers, state.centers.detach())
    assert not torch.equal(centers, train_mod.init_centers(cfg, spec, nc, torch.device("cpu")))

    cfg2, *_ = _setup(tmp_path, "SOLVER.MAX_EPOCHS", "1", "SOLVER.EVAL_PERIOD", "99",
                      "SOLVER.CHECKPOINT_PERIOD", "99")
    state2 = _train(cfg2, spec, (tl, None, nq, nc), max_steps_per_epoch=2, resume_from=path)
    assert state2.epoch == 1 and np.isfinite(state2.loss)
    steps = {int(s["step"]) for s in state2.optimizer.state.values()}
    assert steps == {3}                        # one step before the save, two after


def test_preemption_at_epoch_boundary(tmp_path, monkeypatch):
    """A signal during the epoch-end eval is acted on at the epoch boundary:
    the saved epoch is the completed one, so resume starts at the next."""
    cfg, tl, vl, nq, nc, spec = _setup(tmp_path, "SOLVER.MAX_EPOCHS", "3",
                                       "SOLVER.EVAL_PERIOD", "1", "SOLVER.CHECKPOINT_PERIOD", "99")
    ev = threading.Event()
    real_eval = train_mod._neat_eval

    def eval_then_preempt(*a, **kw):
        out = real_eval(*a, **kw)
        ev.set()
        return out

    monkeypatch.setattr(train_mod, "_neat_eval", eval_then_preempt)
    state = _train(cfg, spec, (tl, vl, nq, nc), max_steps_per_epoch=1, preempt_event=ev)
    assert state.epoch == 1 and state.mAP is not None
    epoch, _ = _saved(_preempt_path(cfg), spec, nc, 3 * spec.feat_dim)
    assert epoch == 1


def test_sigterm_saves_resumes_and_restores_the_handler(tmp_path):
    """A real SIGTERM, sent at the first step through ``train_main``'s
    step callback, reaches the loop's handler; the handler installed before
    is back afterwards; ``--resume`` finishes at MAX_EPOCHS."""
    from signal_tpu_torch.cli import train_main

    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers install from the main thread only")
    args = ["--config_file", "configs/synthetic/smoke.yml",
            "--shrink", ",".join(f"{k}={v}" for k, v in SHRINK.items()),
            "--max_steps_per_epoch", "2", "MODEL.DEVICE", "cpu",
            "INPUT.SIZE_TRAIN", "[64, 64]", "INPUT.SIZE_TEST", "[64, 64]",
            "SOLVER.IMS_PER_BATCH", "8", "DATALOADER.NUM_INSTANCE", "2",
            "TEST.IMS_PER_BATCH", "8", "DATALOADER.NUM_WORKERS", "1",
            "SOLVER.CHECKPOINT_PERIOD", "99", "SOLVER.EVAL_PERIOD", "99",
            "MODEL.METRIC_LOSS_TYPE", "triplet_center", "SOLVER.MAX_EPOCHS", "2",
            "OUTPUT_DIR", str(tmp_path)]
    seen = []

    def before(signum, frame):
        seen.append(signum)

    def send_sigterm(epoch, n_iter):
        if (epoch, n_iter) == (1, 1):
            assert signal.getsignal(signal.SIGTERM) not in (before, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    previous = signal.signal(signal.SIGTERM, before)
    try:
        state = train_main(args, step_callback=send_sigterm)
        assert signal.getsignal(signal.SIGTERM) is before and not seen
    finally:
        signal.signal(signal.SIGTERM, previous)
    path = tmp_path / "synthetic_run" / "Signal_preempt.pth"
    assert state.epoch == 0 and path.exists()
    log = (tmp_path / "synthetic_run" / "train_log.txt").read_text()
    assert "SIGTERM received" in log and "Preemption checkpoint written" in log

    resumed = train_main(["--resume", str(path)] + args)
    assert resumed.epoch == 2 and np.isfinite(resumed.loss)
    # two steps before the save, then epochs 1 and 2 of two steps each
    assert {int(s["step"]) for s in resumed.optimizer.state.values()} == {6}

"""Console entry points of the port (`signal-tpu-torch-train`,
`signal-tpu-torch-test`; port of `signal_tpu/cli.py`).

    signal-tpu-torch-train --config_file configs/RGBNT201/Signal.yml MODEL.DEVICE cuda
    python -m signal_tpu_torch.cli --config_file configs/RGBNT201/Signal.yml \\
        TEST.WEIGHT path/to/Signal.pth MODEL.DEVICE cuda

Runs on ``MODEL.DEVICE`` (``cuda`` unless the config or the command line
says ``cpu``); asking for ``cuda`` where there is none raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random

import numpy as np
import torch


def resolve_device(name: str) -> torch.device:
    """``MODEL.DEVICE`` → torch.device; 'cuda' without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"MODEL.DEVICE={name!r} but torch sees no CUDA device; pass "
            f"MODEL.DEVICE cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"MODEL.DEVICE={name!r}: the port runs on 'cuda' or 'cpu'")
    return device


def parse_spec_overrides(s: str) -> dict:
    """'k=v,...' → ModelSpec override dict (ints/floats/bools coerced), the
    CLI form of ``dataclasses.replace`` (tests and smokes run tiny specs)."""
    def coerce(v: str):
        if v in ("True", "False"):
            return v == "True"
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
        return v

    out = {}
    for kv in filter(None, s.split(",")):
        k, _, v = kv.partition("=")
        out[k.strip()] = coerce(v.strip())
    return out


def build_model_for_test(cfg, num_classes: int, camera_num: int, view_num: int = 1,
                         spec_overrides: dict | None = None):
    """→ (spec, model): a random-init ``Signal`` (seed SOLVER.SEED) with
    TEST.WEIGHT loaded, on ``MODEL.DEVICE``, in eval mode. The class and
    camera counts are the dataset's: the head and SIE shapes must match
    the checkpoint."""
    from signal_tpu_torch.models.signal_model import ModelSpec, init_signal

    device = resolve_device(cfg.MODEL.DEVICE)
    spec = ModelSpec.from_config(cfg, num_classes, camera_num, view_num)
    if spec_overrides:
        spec = dataclasses.replace(spec, **spec_overrides)
    model = init_signal(spec, seed=cfg.SOLVER.SEED)

    weight = cfg.TEST.WEIGHT
    if weight:
        if not weight.endswith((".pth", ".pt")):
            raise ValueError(
                f"TEST.WEIGHT={weight!r}: the port loads reference-named .pth/.pt "
                f"state dicts; convert a JAX (orbax) checkpoint first with "
                f"scripts/export_torch_checkpoint.py, which needs JAX")
        from signal_tpu_torch.models.convert import load_reference_checkpoint

        load_reference_checkpoint(model, weight)
    return spec, model.to(device).eval()


def refuse_dist_train(cfg) -> None:
    """MODEL.DIST_TRAIN asks for a multi-process run, which the JAX package
    sets up (`signal_tpu/cli.py:40-44,169-170`) and the port does not have
    yet: each process would train the whole model on the whole split and
    write the same checkpoints. Raise instead of running single-process."""
    if cfg.MODEL.DIST_TRAIN:
        raise NotImplementedError(
            "MODEL.DIST_TRAIN: multi-process training and evaluation are not ported "
            "yet (scale-out, ROADMAP Queue 1 item 6); unset it to run on one device")


def _seed(cfg) -> None:
    random.seed(cfg.SOLVER.SEED)
    np.random.seed(cfg.SOLVER.SEED)
    torch.manual_seed(cfg.SOLVER.SEED)


def train_main(argv=None, *, preempt_event=None, step_callback=None):
    """Train on the config's train split, evaluating every EVAL_PERIOD
    epochs → the final :class:`signal_tpu_torch.engine.train.TrainState`.
    ``--shrink k=v,...`` replaces ModelSpec fields before init;
    ``--max_steps_per_epoch`` cuts each epoch short (smoke runs);
    ``--resume`` continues from a checkpoint the loop wrote, such as the
    ``<MODEL.NAME>_preempt.pth`` a SIGTERM leaves in the run's directory.
    MODEL.PRETRAIN_PATH_CLIP (or PRETRAIN_PATH_T) names OpenAI's CLIP
    archive, whose visual tower replaces the seeded random one.
    ``preempt_event`` and ``step_callback`` go to :func:`do_train`."""
    parser = argparse.ArgumentParser(description="Signal PyTorch-port training")
    parser.add_argument("--config_file", default="configs/RGBNT201/Signal.yml", type=str)
    parser.add_argument("--shrink", default="",
                        help="ModelSpec overrides k=v,... (smoke runs only)")
    parser.add_argument("--max_steps_per_epoch", default=0, type=int,
                        help="stop each epoch after this many steps (0: the whole epoch)")
    parser.add_argument("--resume", default="", type=str,
                        help="checkpoint (.pth) written by a train run, to continue from")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from signal_tpu_torch.config import load_config

    cfg = load_config(args.config_file if args.config_file else None, args.opts)
    refuse_dist_train(cfg)
    _seed(cfg)

    from signal_tpu_torch.data import make_dataloader
    from signal_tpu_torch.engine.train import do_train
    from signal_tpu_torch.models.signal_model import ModelSpec, init_signal
    from signal_tpu_torch.utils.logger import setup_logger

    out_dir = os.path.join(cfg.OUTPUT_DIR, cfg.ckpt_save_path)
    logger = setup_logger("signal_tpu_torch", out_dir, if_train=True)
    device = resolve_device(cfg.MODEL.DEVICE)
    logger.info("device: %s (%s)", device,
                torch.cuda.get_device_name(device) if device.type == "cuda" else "host")
    logger.info("Running with config:\n%s", cfg.dump())

    (train_loader, _, val_loader, num_query, num_classes, camera_num,
     view_num) = make_dataloader(cfg)
    logger.info("dataset: %s classes=%d cams=%d views=%d query=%d",
                cfg.DATASETS.NAMES, num_classes, camera_num, view_num, num_query)
    spec = ModelSpec.from_config(cfg, num_classes, camera_num, view_num)
    overrides = parse_spec_overrides(args.shrink)
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    model = init_signal(spec, seed=cfg.SOLVER.SEED)
    clip_path = cfg.MODEL.PRETRAIN_PATH_CLIP or cfg.MODEL.PRETRAIN_PATH_T
    if clip_path:
        from signal_tpu_torch.models.clip_loader import load_clip_into_model

        load_clip_into_model(model, clip_path)
        logger.info("Loaded CLIP weights from %s", clip_path)
    return do_train(cfg, model.to(device), train_loader, val_loader, num_query, num_classes,
                    device=device, max_steps_per_epoch=args.max_steps_per_epoch or None,
                    resume_from=args.resume or None, preempt_event=preempt_event,
                    step_callback=step_callback)


def test_main(argv=None):
    """Evaluate on the config's query/gallery split → (cmc, mAP).
    ``--shrink k=v,...`` replaces ModelSpec fields before init (the hook
    tests use to shrink the model)."""
    parser = argparse.ArgumentParser(description="Signal PyTorch-port testing")
    parser.add_argument("--config_file", default="configs/RGBNT201/Signal.yml", type=str)
    parser.add_argument("--shrink", default="",
                        help="ModelSpec overrides k=v,... (smoke runs only)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from signal_tpu_torch.config import load_config

    cfg = load_config(args.config_file if args.config_file else None, args.opts)
    refuse_dist_train(cfg)
    _seed(cfg)

    from signal_tpu_torch.data import make_dataloader
    from signal_tpu_torch.engine.eval import do_inference
    from signal_tpu_torch.utils.logger import setup_logger

    out_dir = os.path.join(cfg.OUTPUT_DIR, cfg.ckpt_test_path)
    logger = setup_logger("signal_tpu_torch", out_dir, if_train=False)

    (_, _, val_loader, num_query, num_classes, camera_num,
     view_num) = make_dataloader(cfg)
    spec, model = build_model_for_test(cfg, num_classes, camera_num, view_num,
                                       spec_overrides=parse_spec_overrides(args.shrink))
    device = next(model.parameters()).device
    logger.info("device: %s (%s)", device,
                torch.cuda.get_device_name(device) if device.type == "cuda" else "host")
    if cfg.TEST.WEIGHT:
        logger.info("Loaded checkpoint %s", cfg.TEST.WEIGHT)
    return do_inference(cfg, model, val_loader, num_query, device=device)


if __name__ == "__main__":
    test_main()

#!/usr/bin/env python
"""Export a Signal checkpoint as a serving artifact of the PyTorch port
(``torch.export``; see signal_tpu_torch/serving.py).

Usage:
  python scripts/export_serving_torch.py --config_file configs/RGBNT201/Signal.yml \
      -o path/to/artifact [--batch 128] [--uint8] [--num_classes 171 --camera_num 4] \
      TEST.WEIGHT path/to/Signal.pth

  --batch N   fixed-shape export; default: symbolic batch (one artifact
              serves any batch size). Either way, on the card
              (MODEL.DEVICE cuda, the default) the hand-written attention
              kernel stays in the graph; on the CPU it takes the eager core
  --uint8     bake uint8→Normalize into the graph (the artifact takes raw
              uint8 crops: 4× fewer bytes to the card)

The artifact serves the device it was exported on (MODEL.DEVICE). Without
``--num_classes`` the class and camera counts come from a scan of the
config's dataset.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config_file", required=True)
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--uint8", action="store_true")
    ap.add_argument("--num_classes", type=int, default=None,
                    help="classifier size (skip the dataset scan)")
    ap.add_argument("--camera_num", type=int, default=None)
    ap.add_argument("--view_num", type=int, default=1,
                    help="view count for the SIE table (MODEL.SIE_VIEW "
                         "checkpoints); must match the training dataset")
    ap.add_argument("opts", nargs="*", default=[])
    args = ap.parse_args(argv)

    from signal_tpu_torch import serving
    from signal_tpu_torch.cli import build_model_for_test
    from signal_tpu_torch.config import load_config

    cfg = load_config(args.config_file, args.opts)
    num_classes, camera_num, view_num = args.num_classes, args.camera_num, args.view_num
    if num_classes is None:
        from signal_tpu_torch.data.datasets import build_dataset

        ds = build_dataset(cfg.DATASETS.NAMES, cfg.DATASETS.ROOT_DIR)
        num_classes, camera_num, view_num = (ds.num_train_pids, ds.num_train_cams,
                                             ds.num_train_vids)
    elif cfg.MODEL.SIE_CAMERA and camera_num is None:
        # a guessed camera count builds an SIE table the checkpoint cannot
        # load into
        raise ValueError("--num_classes was given without --camera_num but "
                         "MODEL.SIE_CAMERA is on; pass the checkpoint dataset's count")
    spec, model = build_model_for_test(cfg, num_classes,
                                       camera_num if camera_num is not None else 1, view_num)

    normalize = (tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)) if args.uint8 else None
    ep = serving.export_eval(model, spec, image_size=tuple(cfg.INPUT.SIZE_TEST),
                             batch=args.batch, normalize=normalize, device=cfg.MODEL.DEVICE)
    path = serving.save_exported(ep, args.out, extra_manifest={
        "config_file": args.config_file,
        "weight": cfg.TEST.WEIGHT,
        "image_size": list(cfg.INPUT.SIZE_TEST),
        "uint8_input": bool(args.uint8),
    })
    print(path)
    return path


if __name__ == "__main__":
    main()

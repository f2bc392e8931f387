"""OpenAI CLIP ``ViT-B-16.pt`` → the port's CLIP tower (port of the dense
path of `signal_tpu/models/clip_loader.py`).

The reference bootstraps every Signal config from CLIP's visual tower
(`modeling/make_model_clipreid.py:177-197`, `modeling/clip/model.py:
651-729` in maxingan2412/Signal): read the archive (TorchScript, as
OpenAI ships it, or a plain state dict), keep ``visual.*``, convert to
fp32, and bilinear-resize the positional embedding from the pretrained
14×14 grid to the ReID grid (16×8 at 256×128, 8×16 at 128×256). The
port's tower keeps CLIP's parameter names, so the mapping is a rename
plus that resize.

Unlike the JAX package, which skips a path that does not exist, the port
raises: a mistyped path must not train from random weights.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from signal_tpu_torch.models.vit import VisionTransformer, resize_pos_embed


def _torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the archive at ``path``, in fp32 on the CPU: a
    TorchScript archive first, else a plain state dict or one nested under
    ``state_dict``."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:  # not TorchScript: a torch.save'd dict
        obj = torch.load(path, map_location="cpu", weights_only=True)
        sd = obj["state_dict"] if "state_dict" in obj else obj
    return {k: v.float() for k, v in sd.items() if isinstance(v, torch.Tensor)}


def clip_visual_to_tower(sd: Dict[str, torch.Tensor], tower: VisionTransformer, h: int,
                         w: int) -> Dict[str, torch.Tensor]:
    """CLIP ``visual.*`` tensors → a state dict for ``tower`` (the first
    ``layers`` blocks of the archive), the positional embedding resized
    from the pretrained square grid to the h×w patch grid. (A trained
    checkpoint, whose grid is already h×w, loads as it is through
    ``convert.load_reference_checkpoint``.)"""
    want = tower.state_dict()
    missing = [k for k in want if f"visual.{k}" not in sd]
    if missing:
        raise KeyError(f"the CLIP archive lacks visual.{missing[0]} "
                       f"({len(missing)} tower tensors missing)")
    out = {k: sd[f"visual.{k}"] for k in want}
    out["positional_embedding"] = resize_pos_embed(out["positional_embedding"], h, w)
    for k, v in out.items():
        if v.shape != want[k].shape:
            raise ValueError(f"visual.{k}: archive shape {tuple(v.shape)}, the tower's "
                             f"{tuple(want[k].shape)} (another CLIP width or patch size?)")
    return out


def load_clip_into_model(model, path: str):
    """Replace ``model.clip_vision_encoder.base`` (a port ``Signal``) with
    the CLIP visual tower at ``path`` (`load_clip_into_params`, dense CLIP
    path); every other weight stays as it was. → ``model``."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"MODEL.PRETRAIN_PATH_CLIP={path!r} does not exist")
    tower = model.clip_vision_encoder.base
    sd = clip_visual_to_tower(_torch_state_dict(path), tower, model.spec.h, model.spec.w)
    tower.load_state_dict(sd, strict=True)
    return model

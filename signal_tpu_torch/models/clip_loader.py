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

The tower's variants keep what CLIP has no weights for, as the JAX
loader does (`signal_tpu/models/clip_loader.py:100-120`): the freshly
initialised adapters, prompts and LoRA factors stay, the LoRA-adapted
kernels take CLIP's weights as their base, and an MoE tower's experts are
all sparse-upcycled from the block's dense CLIP MLP while its router stays
fresh.

Unlike the JAX package, which skips a path that does not exist, the port
raises: a mistyped path must not train from random weights.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from signal_tpu_torch.models.lora import plain_name
from signal_tpu_torch.models.vit import VisionTransformer, resize_pos_embed
from signal_tpu_torch.ops.moe import upcycle_dense_mlp


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


def _archive_key(key: str) -> str | None:
    """The CLIP archive's name (without ``visual.``) for a key of the
    tower's state dict; None for what CLIP has no weights for (adapters,
    prompts, LoRA factors, MoE)."""
    key = plain_name(key)
    if key is None:
        return None                           # LoRA factors
    if ".moe." in key or any(part.startswith("adapter_") for part in key.split(".")):
        return None
    return key


def clip_visual_to_tower(sd: Dict[str, torch.Tensor], tower: VisionTransformer, h: int,
                         w: int) -> Dict[str, torch.Tensor]:
    """CLIP ``visual.*`` tensors → a state dict for ``tower`` (the first
    ``layers`` blocks of the archive), the positional embedding resized
    from the pretrained square grid to the h×w patch grid. What CLIP has no
    weights for keeps the tower's current values, but an MoE block's
    experts, which are upcycled from the block's dense MLP. (A trained
    checkpoint, whose grid is already h×w, loads as it is through
    ``convert.load_reference_checkpoint``.)"""
    want = tower.state_dict()
    names = {k: _archive_key(k) for k in want}
    moe_blocks = [i for i, blk in enumerate(tower.transformer.resblocks) if blk.is_moe]
    dense = [f"transformer.resblocks.{i}.mlp.{lin}.{t}" for i in moe_blocks
             for lin in ("c_fc", "c_proj") for t in ("weight", "bias")]
    missing = [a for a in [*names.values(), *dense]
               if a is not None and f"visual.{a}" not in sd]
    if missing:
        raise KeyError(f"the CLIP archive lacks visual.{missing[0]} "
                       f"({len(missing)} tower tensors missing)")
    out = {k: want[k] if a is None else sd[f"visual.{a}"] for k, a in names.items()}
    out["positional_embedding"] = resize_pos_embed(out["positional_embedding"], h, w)
    for i in moe_blocks:
        b = f"visual.transformer.resblocks.{i}.mlp."
        up = upcycle_dense_mlp(sd[b + "c_fc.weight"], sd[b + "c_fc.bias"],
                               sd[b + "c_proj.weight"], sd[b + "c_proj.bias"],
                               tower.transformer.resblocks[i].moe.router.shape[-1])
        out.update({f"transformer.resblocks.{i}.moe.{n}": t for n, t in up.items()})
    for k, v in out.items():
        if v.shape != want[k].shape:
            raise ValueError(f"visual.{names[k]}: archive shape {tuple(v.shape)}, the tower's "
                             f"{tuple(want[k].shape)} (another CLIP width or patch size?)")
    return out


def load_clip_into_model(model, path: str):
    """Replace ``model.clip_vision_encoder.base`` (a port ``Signal``) with
    the CLIP visual tower at ``path`` (`load_clip_into_params`); every
    other weight stays as it was. → ``model``."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"MODEL.PRETRAIN_PATH_CLIP={path!r} does not exist")
    tower = model.clip_vision_encoder.base
    sd = clip_visual_to_tower(_torch_state_dict(path), tower, model.spec.h, model.spec.w)
    tower.load_state_dict(sd, strict=True)
    return model

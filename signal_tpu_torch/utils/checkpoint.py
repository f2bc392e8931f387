"""Training checkpoints as ``torch.save`` files (port of
`signal_tpu/utils/checkpoint.py`, which writes orbax directories).

A full checkpoint holds the model's reference-named state dict under
``state_dict`` (so ``TEST.WEIGHT`` and ``load_reference_checkpoint`` read
it as they read a reference ``.pth``), the optimizer's state, the last
completed epoch, the RNG state (torch's CPU generator and the train
step's augmentation generator) and, with center loss, the class centres.
``--resume`` restores all of it and continues at the next epoch.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn


def save_checkpoint(path: str, model: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None,
                    epoch: int = 0, gen: Optional[torch.Generator] = None,
                    centers: Optional[torch.Tensor] = None) -> str:
    """Write ``path`` (atomically: a reader never sees half a file). A full
    checkpoint (``optimizer`` given) also holds ``gen``'s state and the
    ``centers``."""
    obj = {"state_dict": model.state_dict(), "epoch": epoch}
    if optimizer is not None:
        obj["optimizer"] = optimizer.state_dict()
        obj["rng"] = {"torch_cpu": torch.get_rng_state()}
        if gen is not None:
            obj["rng"]["augment"] = gen.get_state()
        if centers is not None:
            obj["centers"] = centers.detach()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, model: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None,
                    gen: Optional[torch.Generator] = None,
                    centers: Optional[torch.Tensor] = None) -> int:
    """Restore what ``save_checkpoint`` wrote into ``model`` (strict), the
    optimizer, the generators and (in place) the ``centers``, where the
    checkpoint holds them; → the saved epoch."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(obj["state_dict"], strict=True)
    if optimizer is not None:
        if "optimizer" not in obj:
            raise KeyError(f"{path} holds no optimizer state: it is not a resumable checkpoint")
        optimizer.load_state_dict(obj["optimizer"])
        torch.set_rng_state(obj["rng"]["torch_cpu"])
        if gen is not None and "augment" in obj["rng"]:
            gen.set_state(obj["rng"]["augment"])
    if centers is not None and "centers" in obj:
        with torch.no_grad():
            centers.copy_(obj["centers"])
    return int(obj["epoch"])

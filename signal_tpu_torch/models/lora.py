"""LoRA factors for the ViT towers under MODEL.FROZEN (port of
`signal_tpu/models/lora.py`; the reference's `modeling/clip/LoRA.py`).

The backbone is frozen and low-rank factors train instead: each adapted
kernel W becomes W + (A·B)·scale, with A [din, r] kaiming-uniform,
B [r, dout] zero (so the tower starts as it was) and scale = alpha / r,
alpha = 2r, a constant that is never optimised. The targets are the JAX
package's: every kernel whose tree path ends in ``qkv_kernel``,
``out_kernel``, ``fc_kernel`` or ``proj_kernel``. Each tower names its
own in ``lora_paths()``:

* the CLIP tower: each block's packed ``attn.in_proj_weight``,
  ``attn.out_proj.weight``, ``mlp.c_fc.weight`` and ``mlp.c_proj.weight``
  (its own ``proj`` is not one, as in JAX);
* the ImageNet ViT: each block's ``attn.qkv.weight``, ``attn.proj.weight``,
  ``mlp.fc1.weight`` and ``mlp.fc2.weight``;
* T2T: those of its blocks, and the two token transformers'
  ``attn.qkv.weight`` (JAX's ``t2t.attn{1,2}.qkv_kernel``), but not their
  ``attn.proj`` or the ``project`` layer, whose JAX paths end in
  ``.kernel``.

The CNNs take none, as in JAX.

The merge is a ``torch.nn.utils.parametrize`` parametrization, so every
read of an adapted weight (the forward, and a checkpointed block's
recompute) returns the merged one, computed in true fp32 at each forward
(JAX: ``Precision.HIGHEST``), and gradients reach the factors; the solver
freezes the base weights. A and B keep JAX's ``[din, r]`` and ``[r, dout]``
layout, and the product is transposed onto torch's ``[dout, din]``
weights. The reference has no state-dict names for them and JAX's export
refuses FROZEN, so these are the port's own, for each target
``<module>.<weight>``:

* ``<module>.parametrizations.<weight>.original``: the frozen base weight;
* ``<module>.parametrizations.<weight>.0.lora_A`` and ``.0.lora_B``: the
  factors;
* ``<module>.parametrizations.<weight>.0.lora_scale``: alpha / r, a
  buffer.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch
from torch import nn
from torch.nn.utils import parametrize

from signal_tpu_torch.ops.attention import true_fp32

# the CLIP tower's adapted kernels: (submodule of a block, its weight)
TARGETS = (("attn", "in_proj_weight"), ("attn.out_proj", "weight"),
           ("mlp.c_fc", "weight"), ("mlp.c_proj", "weight"))


def apply_lora(weight: torch.Tensor, lora_A: torch.Tensor, lora_B: torch.Tensor,
               lora_scale: torch.Tensor) -> torch.Tensor:
    """The merged weight W + (A·B)ᵀ·scale of a ``[dout, din]`` weight, the
    product in true fp32."""
    with true_fp32():
        delta = lora_A.float() @ lora_B.float()
    return weight + (lora_scale * delta).t().to(weight.dtype)


class LoRA(nn.Module):
    """The parametrization of one adapted ``[dout, din]`` weight."""

    def __init__(self, din: int, dout: int, rank: int, alpha: float):
        super().__init__()
        self.lora_A = nn.Parameter(torch.zeros(din, rank))
        self.lora_B = nn.Parameter(torch.zeros(rank, dout))
        self.register_buffer("lora_scale", torch.tensor(alpha / rank))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """A ~ U(±1/√din) (kaiming-uniform), B = 0."""
        bound = 1.0 / math.sqrt(max(self.lora_A.shape[0], 1))
        self.lora_A.uniform_(-bound, bound, generator=gen)
        self.lora_B.zero_()

    def forward(self, weight: torch.Tensor) -> torch.Tensor:
        return apply_lora(weight, self.lora_A, self.lora_B, self.lora_scale)


def lora_targets(tower: nn.Module) -> Iterator[Tuple[nn.Module, str]]:
    """(module, weight name) of every adapted kernel of the tower, in the
    order of its ``lora_paths()``."""
    for path in tower.lora_paths():
        module, weight = path.rsplit(".", 1)
        yield tower.get_submodule(module), weight


def init_lora_factors(tower: nn.Module, *, rank: int = 8, alpha: float = 16.0) -> None:
    """Register a :class:`LoRA` parametrization on every target of the
    tower, with zero factors (``init_signal`` draws A; a state dict
    overwrites both)."""
    for module, weight in lora_targets(tower):
        dout, din = getattr(module, weight).shape
        parametrize.register_parametrization(module, weight, LoRA(din, dout, rank, alpha))


def lora_modules(tower: nn.Module) -> Iterator[LoRA]:
    """Every :class:`LoRA` of the tower, in the order of ``lora_targets``."""
    for module, weight in lora_targets(tower):
        yield module.parametrizations[weight][0]


def plain_name(key: str) -> str | None:
    """A state-dict key as the module would name it without LoRA: an
    adapted weight's ``….parametrizations.<weight>.original`` is
    ``….<weight>``; the factors and their scale are None."""
    if ".parametrizations." not in key:
        return key
    if not key.endswith(".original"):
        return None
    return key.replace(".parametrizations.", ".").removesuffix(".original")


@torch.no_grad()
def copy_plain_(module: nn.Module, src: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy each tensor of ``src`` (keyed by :func:`plain_name`s, e.g. an
    upstream checkpoint's names) into ``module``'s tensor of that name, in
    place; under LoRA an adapted weight's base takes it. Raises on a key
    the module does not hold or a shape it does not have. → ``module``."""
    state = {plain_name(k): v for k, v in module.state_dict(keep_vars=True).items()}
    for key, value in src.items():
        if key not in state:
            raise KeyError(f"{key!r} is not a tensor of {type(module).__name__}")
        if tuple(value.shape) != tuple(state[key].shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)}, the module's "
                             f"{tuple(state[key].shape)}")
        state[key].copy_(value)
    return module

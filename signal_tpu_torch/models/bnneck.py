"""BNNeck: BatchNorm1d with running statistics (port of
`signal_tpu/models/bnneck.py`).

The reference's BNNeck heads (`modeling/make_model.py:77-117` in
maxingan2412/Signal) are affine BatchNorm1d layers whose bias is frozen at
zero. Training normalizes with the batch's biased variance and updates the
running variance with the unbiased one, momentum 0.1, all in fp32; eval
uses the running statistics.
"""

from __future__ import annotations

import torch
from torch import nn


class BNNeck(nn.Module):
    """BatchNorm1d's parameters and running stats (``weight``, ``bias``,
    ``running_mean``, ``running_var``) without ``num_batches_tracked``,
    which the JAX package does not carry. The bias does not train."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))


def bnneck_apply(bn: BNNeck, x: torch.Tensor, *, training: bool, momentum: float = 0.1,
                 eps: float = 1e-5) -> torch.Tensor:
    """x [B, D] → normalized [B, D] fp32. In training the running stats are
    updated in place (fp32, ``(1 − m)·old + m·new``)."""
    x32 = x.float()
    if training:
        mean = x32.mean(dim=0)
        var = x32.var(dim=0, unbiased=False)
        n = x32.shape[0]
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            bn.running_mean.copy_((1 - momentum) * bn.running_mean + momentum * mean)
            bn.running_var.copy_((1 - momentum) * bn.running_var + momentum * unbiased)
    else:
        mean, var = bn.running_mean, bn.running_var
    y = (x32 - mean) / torch.sqrt(var + eps)
    return y * bn.weight.float() + bn.bias.float()

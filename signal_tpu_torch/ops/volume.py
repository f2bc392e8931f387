"""GAM's Gram volume, closed form (port of `signal_tpu/ops/volume.py`).

The reference builds a [B1, B2, 3, 3] stack of Gram matrices and runs
``torch.det``; the 3×3 determinant expands to a short polynomial in six
dot-product maps: two GEMMs plus elementwise work, in true fp32 (the
determinant cancels, and TF32 would show).
"""

from __future__ import annotations

import torch

from signal_tpu_torch.ops.attention import true_fp32


def gram_volume3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 eps: float = 1e-12) -> torch.Tensor:
    """sqrt(|det Gram([a_i, b_j, c_j])| + eps) for every (i, j) pair.
    a [B1, D]; b, c [B2, D] → [B1, B2] fp32. eps sits inside the sqrt, so
    the gradient stays bounded where the volume touches 0."""
    a, b, c = a.float(), b.float(), c.float()
    aa = (a * a).sum(-1)[:, None]
    with true_fp32():
        ab = a @ b.T
        ac = a @ c.T
    bb = (b * b).sum(-1)[None, :]
    bc = (b * c).sum(-1)[None, :]
    cc = (c * c).sum(-1)[None, :]
    det = aa * (bb * cc - bc * bc) - ab * (ab * cc - bc * ac) + ac * (ab * bc - bb * ac)
    return torch.sqrt(det.abs() + eps)

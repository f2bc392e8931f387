"""MambaPro prompt branch of the CLIP tower, MODEL.PROMPT (port of
`signal_tpu/models/vit_prompt.py`, the reference's ``forward_with_prompt``,
`modeling/clip/model.py:298-340`, and with MODEL.ADAPTER on its
``forward_with_prompt_adapter``, `:342-386`, which ``_block`` gives).

Each block appends three groups of ``K_PROMPT`` = 4 prompt tokens:

* the modality's own prompt: block 0 uses its learned prompt; block i > 0
  uses last + transfer(last) + its learned prompt, where ``last`` is the
  mean of the three prompt groups of the previous block's output;
* two cross-modality prompts, prompt + adapter(prompt), rebuilt in every
  block.

The concat order depends on the modality (rgb: [x, r, n2r, t2r]; nir:
[x, r2n, n, t2n]; tir: [x, r2t, n2t, t]) and the prompts are stripped
after each block, so a stream of 129 tokens runs its blocks at 141. The
wiring differs per modality, so the three modalities run as three encoder
calls, not as one [3B, …] batch. The parameters live in each block under
the reference's names (``models/vit.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from signal_tpu_torch.models.vit import (
    K_PROMPT,
    ResidualAttentionBlock,
    VisionTransformer,
    _block,
    embed_patches,
)
from signal_tpu_torch.ops.attention import layer_norm, linear, matmul_f32, quick_gelu

# the cross-modality adapters by the modality whose prompt they carry
_CROSS = {"rgb": "adapter_r", "nir": "adapter_n", "tir": "adapter_t"}
MODALITY_ORDER = ("rgb", "nir", "tir")


def _mlp_apply(mlp: nn.Sequential, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """A prompt MLP (Linear ``.0``, QuickGELU, Dropout, Linear ``.3``) → fp32."""
    h = quick_gelu(linear(mlp[0].weight, mlp[0].bias, x, compute_dtype))
    return linear(mlp[3].weight, mlp[3].bias, h, compute_dtype)


def prompt_block(blk: ResidualAttentionBlock, x: torch.Tensor,
                 last_prompt: Optional[torch.Tensor], modality: str, *, num_heads: int,
                 compute_dtype, use_flash: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One prompted block. x [B, L, D]; last_prompt [B, k, D] or None →
    (x without the prompts, the prompt of this block [B, k, D])."""
    B, L, _ = x.shape
    k = K_PROMPT

    def expand(tokens: torch.Tensor) -> torch.Tensor:
        return tokens[None].expand(B, *tokens.shape)

    own = expand(getattr(blk, f"adapter_prompt_{modality}"))
    if last_prompt is not None:
        own = last_prompt + _mlp_apply(blk.adapter_transfer, last_prompt, compute_dtype) + own
    groups = []
    for m in MODALITY_ORDER:
        if m == modality:
            groups.append(own)
        else:
            p = expand(getattr(blk, f"adapter_prompt_{m}"))
            groups.append(p + _mlp_apply(getattr(blk, _CROSS[m]), p, compute_dtype))
    # the residual stream keeps its dtype: fp32 prompt tokens would
    # otherwise promote the whole sequence
    seq = torch.cat([x] + [g.to(x.dtype) for g in groups], dim=1)
    seq = _block(blk, seq, num_heads=num_heads, compute_dtype=compute_dtype,
                 use_flash=use_flash)
    body, tail = seq[:, :L], seq[:, L:]
    return body, (tail[:, :k] + tail[:, k:2 * k] + tail[:, 2 * k:]) / 3.0


def vit_forward_prompt(vit: VisionTransformer, images: torch.Tensor, cv_emb, modality: str, *,
                       num_heads: int = 12, compute_dtype=torch.bfloat16,
                       use_flash: bool = False, stride: int | None = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prompted forward of one modality's images [B, 3, H, W] →
    (patch tokens [B, L, out], cls [B, out]), fp32, like ``vit_forward``.

    Under grad mode every prompted block is checkpointed, whatever
    MODEL.REMAT says (`vit_prompt.py:121-126`: three prompted streams would
    not fit otherwise); each block then launches the forward kernel twice
    in a train step, so a step launches it 72 times and the backward 36
    times over the three streams of 12 blocks."""
    x = embed_patches(vit, images, cv_emb, stride=stride, compute_dtype=compute_dtype)
    x = x.to(compute_dtype)
    last = None
    for blk in vit.transformer.resblocks:
        def step(x, last, blk=blk):
            return prompt_block(blk, x, last, modality, num_heads=num_heads,
                                compute_dtype=compute_dtype, use_flash=use_flash)

        if torch.is_grad_enabled():
            x, last = torch.utils.checkpoint.checkpoint(step, x, last, use_reentrant=False)
        else:
            x, last = step(x, last)
    x = layer_norm(vit.ln_post, x)
    x = matmul_f32(x.to(compute_dtype), vit.proj.to(compute_dtype))
    return x[:, 1:], x[:, 0]

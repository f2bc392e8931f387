"""CLIP text tower and CLIP-ReID's prompt learner (port of
`signal_tpu/models/text_encoder.py`).

The text half of `modeling/clip/model.py` and the PromptLearner of
`modeling/make_model_clipreid.py:34-246` (maxingan2412/Signal):

* :class:`TextTransformer` holds OpenAI CLIP's text parameters under
  CLIP's names (``token_embedding.weight``, ``positional_embedding``,
  ``transformer.resblocks.{i}.*``, ``ln_final``, ``text_projection``), so
  an archive's text half loads by name (:func:`load_clip_text_params`);
* :func:`text_forward`: embedded prompts + positional embedding → causal
  pre-LN blocks (QuickGELU MLP) → ln_final → the EOT token's state →
  ``text_projection``. The residual stream stays fp32 (unlike the ViT's
  compute-dtype stream); the products take their operands in the compute
  dtype with fp32 accumulation. The masked attention is the eager core, as
  in JAX: the kernel takes no mask;
* :class:`PromptLearner`: "A photo of a X X X X person." (vehicle for the
  vehicle datasets) with the four X replaced by per-class learned context
  vectors ``cls_ctx``; the template's embedded prefix and suffix and its
  token ids are buffers, as the reference registers them (leaves of the
  JAX tree).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from signal_tpu_torch.models.vit import _Transformer
from signal_tpu_torch.ops.attention import layer_norm, linear, matmul_f32, mha, quick_gelu

N_CTX = 4       # the template's context "A photo of a"
N_CLS_CTX = 4   # the learned per-class slots (the X X X X)
VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
VEHICLE_DATASETS = ("VehicleID", "veri", "RGBNT100", "MSVR310")


def causal_mask(n: int, device=None) -> torch.Tensor:
    """CLIP's additive causal mask [n, n] fp32: −inf above the diagonal, 0
    elsewhere (filled, never multiplied: 0·−inf is NaN)."""
    above = torch.ones(n, n, dtype=torch.bool, device=device).triu(1)
    return torch.zeros(n, n, device=device).masked_fill(above, float("-inf"))


class TextTransformer(nn.Module):
    """Parameters of CLIP's text tower (its 49,408-token vocabulary and 77
    positions); the forward is :func:`text_forward`."""

    def __init__(self, *, width: int = 512, layers: int = 12, embed_dim: int = 512):
        super().__init__()
        self.token_embedding = nn.Embedding(VOCAB_SIZE, width)
        self.positional_embedding = nn.Parameter(torch.empty(CONTEXT_LENGTH, width))
        self.transformer = _Transformer(width, layers)
        self.ln_final = nn.LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """`init_text_params`' distributions: token embedding N(0, 0.02),
        positions N(0, 0.01), the blocks as the CLIP tower's, projection
        N(0, 1/width)."""
        width = self.positional_embedding.shape[1]
        self.token_embedding.weight.normal_(0.0, 0.02, generator=gen)
        self.positional_embedding.normal_(0.0, 0.01, generator=gen)
        for blk in self.transformer.resblocks:
            blk.reset_parameters(gen)
        self.ln_final.reset_parameters()
        self.text_projection.normal_(0.0, width ** -0.5, generator=gen)


def text_forward(text: TextTransformer, prompts: torch.Tensor, tokenized: torch.Tensor, *,
                 num_heads: int = 8, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """prompts [B, 77, width] (already embedded), tokenized [B, 77] int ids
    → text features [B, embed_dim] fp32. The EOT position is the argmax of
    the ids (`make_model_clipreid.py:52`)."""
    x = prompts.float() + text.positional_embedding.float()[None]
    mask = causal_mask(x.shape[1], device=x.device)
    for blk in text.transformer.resblocks:
        x = x + mha(blk.attn, layer_norm(blk.ln_1, x), num_heads=num_heads,
                    compute_dtype=compute_dtype, mask=mask)
        m = layer_norm(blk.ln_2, x)
        m = quick_gelu(linear(blk.mlp.c_fc.weight, blk.mlp.c_fc.bias, m, compute_dtype))
        x = x + linear(blk.mlp.c_proj.weight, blk.mlp.c_proj.bias, m, compute_dtype)
    x = layer_norm(text.ln_final, x)
    pooled = x[torch.arange(x.shape[0], device=x.device), tokenized.argmax(dim=-1)]
    return matmul_f32(pooled.to(compute_dtype), text.text_projection.to(compute_dtype))


class PromptLearner(nn.Module):
    """CLIP-ReID's per-class prompts: ``cls_ctx [C, 4, width]`` learns; the
    template's ``token_prefix [5, width]``, ``token_suffix [68, width]``
    and ``tokenized [77]`` are buffers, set from a token embedding by
    :meth:`set_template`."""

    def __init__(self, num_classes: int, dataset_name: str, token_embedding: torch.Tensor,
                 tokenizer):
        super().__init__()
        width = token_embedding.shape[-1]
        self.noun = "vehicle" if dataset_name in VEHICLE_DATASETS else "person"
        self.cls_ctx = nn.Parameter(torch.empty(num_classes, N_CLS_CTX, width))
        self.register_buffer("token_prefix", torch.empty(N_CTX + 1, width))
        self.register_buffer("token_suffix",
                             torch.empty(CONTEXT_LENGTH - N_CTX - 1 - N_CLS_CTX, width))
        self.register_buffer("tokenized", torch.empty(CONTEXT_LENGTH, dtype=torch.long))
        self.set_template(token_embedding, tokenizer)

    @torch.no_grad()
    def set_template(self, token_embedding: torch.Tensor, tokenizer) -> None:
        """The template's ids and their rows of ``token_embedding`` [vocab,
        width] into the buffers (`init_prompt_learner`)."""
        tokenized = tokenizer.tokenize(f"A photo of a X X X X {self.noun}.")[0]
        embedded = token_embedding.detach()[tokenized.to(token_embedding.device)]
        self.tokenized.copy_(tokenized)
        self.token_prefix.copy_(embedded[: N_CTX + 1])
        self.token_suffix.copy_(embedded[N_CTX + 1 + N_CLS_CTX:])

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """``cls_ctx`` ~ N(0, 0.02)."""
        self.cls_ctx.normal_(0.0, 0.02, generator=gen)


def prompt_forward(pl: PromptLearner, labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """labels [B] → (prompts [B, 77, width], tokenized [B, 77])."""
    B = labels.shape[0]
    prompts = torch.cat([pl.token_prefix.expand(B, -1, -1), pl.cls_ctx[labels],
                         pl.token_suffix.expand(B, -1, -1)], dim=1)
    return prompts, pl.tokenized.expand(B, -1)


def load_clip_text_params(sd: Dict[str, torch.Tensor], layers: int = 12,
                          tokenizer=None) -> Dict[str, torch.Tensor]:
    """A CLIP archive's state dict → the text half for a
    :class:`TextTransformer` of ``layers`` blocks (CLIP's names, so a
    selection by name; the archive's first ``layers`` blocks).

    Pretrained text weights are meaningful only against OpenAI's token ids:
    raises ``ValueError`` when the tokenizer in play (``tokenizer``, or the
    default resolution when None) is the byte-fallback vocabulary."""
    from signal_tpu_torch.models.tokenizer import resolve_bpe_path

    fallback = (not tokenizer.has_merges if tokenizer is not None
                else resolve_bpe_path() is None)
    if fallback:
        raise ValueError(
            "Loading pretrained CLIP text weights with a byte-fallback "
            "tokenizer vocabulary: token ids will not match the tower's "
            "embedding rows. Provide bpe_simple_vocab_16e6.txt.gz via "
            "ClipTokenizer(bpe_path=...) or SIGNAL_TPU_BPE_PATH (the port's "
            "signal_tpu_torch/models/data/ copy is missing).")
    keys = ["token_embedding.weight", "positional_embedding", "ln_final.weight",
            "ln_final.bias", "text_projection"]
    block = ("ln_1.weight", "ln_1.bias", "attn.in_proj_weight", "attn.in_proj_bias",
             "attn.out_proj.weight", "attn.out_proj.bias", "ln_2.weight", "ln_2.bias",
             "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias")
    keys += [f"transformer.resblocks.{i}.{k}" for i in range(layers) for k in block]
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"the CLIP archive lacks {missing[0]} ({len(missing)} text tensors "
                       f"missing)")
    return {k: sd[k] for k in keys}

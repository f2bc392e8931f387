"""CLIP-ReID: the prompt-learning CLIP ViT-B/16 ReID model (port of
`signal_tpu/models/clipreid.py`).

`modeling/make_model_clipreid.py:55-173` (maxingan2412/Signal): one
modality through the CLIP image tower, with

* two feature heads: the 768-d ln_post CLS and the 512-d projected CLS,
  each with its own BNNeck and bias-free classifier;
* :func:`clipreid_text_features`: each class's learned prompt ("A photo of
  a X X X X person.") through the CLIP text tower;
* :func:`clipreid_image_features`: the projected CLS;
* :func:`clipreid_forward_train` → ([cls_score, cls_score_proj],
  [feat_last, feat, feat_proj], feat_proj), the BNNecks' statistics moved;
* :func:`clipreid_forward_eval`: the 768-d and 512-d features joined,
  before or after the BNNecks (TEST.NECK_FEAT).

The image tower takes the attention kernels under
MODEL.USE_PALLAS_ATTENTION and is checkpointed per block ('full') under
grad mode, as JAX's ``vit_forward`` remats by default; the text tower's
causal attention is the eager core (``text_encoder.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from signal_tpu_torch.models.bnneck import BNNeck, bnneck_apply
from signal_tpu_torch.models.text_encoder import PromptLearner, TextTransformer, \
    prompt_forward, text_forward
from signal_tpu_torch.models.vit import VisionTransformer, vit_forward
from signal_tpu_torch.ops.attention import trunc_normal_

TEXT_HEADS = 8   # CLIP's text tower, fixed (`signal_tpu/models/clipreid.py:115-118`)


@dataclasses.dataclass(frozen=True)
class ClipReIDSpec:
    """The JAX package's ``ClipReIDSpec`` fields, and the text tower's width
    and depth (JAX fixes them at CLIP's 512 and 12), which the tests
    shrink."""
    num_classes: int
    camera_num: int
    width: int = 768            # in_planes (ViT-B-16)
    proj_dim: int = 512         # in_planes_proj
    layers: int = 12
    num_heads: int = 12
    h: int = 16
    w: int = 8
    stride_size: int = 16
    sie_camera: bool = True
    sie_coe: float = 1.0
    neck_feat: str = "before"
    compute_dtype: str = "bfloat16"
    use_flash: bool = False
    dataset_name: str = "RGBNT201"
    text_width: int = 512
    text_layers: int = 12

    @classmethod
    def from_config(cls, cfg, num_classes: int, camera_num: int) -> "ClipReIDSpec":
        return cls(
            num_classes=num_classes,
            camera_num=camera_num,
            h=(cfg.INPUT.SIZE_TRAIN[0] - 16) // cfg.MODEL.STRIDE_SIZE[0] + 1,
            w=(cfg.INPUT.SIZE_TRAIN[1] - 16) // cfg.MODEL.STRIDE_SIZE[1] + 1,
            stride_size=int(cfg.MODEL.STRIDE_SIZE[0]),
            sie_camera=bool(cfg.MODEL.SIE_CAMERA),
            sie_coe=float(cfg.MODEL.SIE_COE),
            neck_feat=cfg.TEST.NECK_FEAT,
            compute_dtype=cfg.MODEL.COMPUTE_DTYPE,
            use_flash=bool(cfg.MODEL.USE_PALLAS_ATTENTION),
            dataset_name=cfg.DATASETS.NAMES,
        )

    @property
    def cdtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.compute_dtype]


class ClipReID(nn.Module):
    """CLIP-ReID's parameters under the reference's names, with random
    weights from ``gen`` (default seed 0) by `init_clipreid_params`'
    distributions: the image tower's, the text tower's, SIE
    trunc-normal(0.02), classifiers N(0, 0.001), BNNecks ones and zeros,
    ``cls_ctx`` N(0, 0.02). The prompt learner's buffers come from the
    drawn token embedding and ``tokenizer`` (default: the port's CLIP
    vocabulary). On the CPU; move it with ``.to``."""

    def __init__(self, spec: ClipReIDSpec, gen: Optional[torch.Generator] = None,
                 tokenizer=None):
        super().__init__()
        if tokenizer is None:
            from signal_tpu_torch.models.tokenizer import ClipTokenizer

            tokenizer = ClipTokenizer()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.spec = spec
        self.base = VisionTransformer(h_resolution=spec.h, w_resolution=spec.w,
                                      width=spec.width, layers=spec.layers,
                                      output_dim=spec.proj_dim)
        self.text = TextTransformer(width=spec.text_width, layers=spec.text_layers,
                                    embed_dim=spec.proj_dim)
        self.cv_embed = (nn.Parameter(torch.empty(spec.camera_num, spec.width))
                         if spec.sie_camera else None)
        self.classifier = nn.Linear(spec.width, spec.num_classes, bias=False)
        self.classifier_proj = nn.Linear(spec.proj_dim, spec.num_classes, bias=False)
        self.bottleneck = BNNeck(spec.width)
        self.bottleneck_proj = BNNeck(spec.proj_dim)
        with torch.no_grad():
            self.base.reset_parameters(gen)
            self.text.reset_parameters(gen)
            if self.cv_embed is not None:
                trunc_normal_(self.cv_embed, gen)
            self.classifier.weight.normal_(0.0, 0.001, generator=gen)
            self.classifier_proj.weight.normal_(0.0, 0.001, generator=gen)
        self.prompt_learner = PromptLearner(spec.num_classes, spec.dataset_name,
                                            self.text.token_embedding.weight, tokenizer)
        self.prompt_learner.reset_parameters(gen)


def _image_triple(model: ClipReID, images: torch.Tensor, cam_label=None):
    spec = model.spec
    cv = None
    if spec.sie_camera and cam_label is not None:
        cv = spec.sie_coe * model.cv_embed[cam_label]
    return vit_forward(model.base, images, cv, num_heads=spec.num_heads,
                       compute_dtype=spec.cdtype, use_flash=spec.use_flash,
                       stride=spec.stride_size, remat=True, return_intermediate=True)


def clipreid_text_features(model: ClipReID, labels: torch.Tensor) -> torch.Tensor:
    """labels [B] → each label's prompt through the text tower [B, proj_dim]."""
    prompts, tokenized = prompt_forward(model.prompt_learner, labels)
    return text_forward(model.text, prompts, tokenized, num_heads=TEXT_HEADS,
                        compute_dtype=model.spec.cdtype)


def clipreid_image_features(model: ClipReID, images: torch.Tensor,
                            cam_label=None) -> torch.Tensor:
    """images [B, 3, H, W] → the projected CLS [B, proj_dim] fp32."""
    return _image_triple(model, images, cam_label)[2][:, 0]


def clipreid_forward_train(model: ClipReID, images: torch.Tensor, cam_label=None
                           ) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """→ (scores [2], feats [3: last, post, proj], feat_proj); the BNNecks'
    running statistics move in place."""
    x_last, x_post, x_proj = _image_triple(model, images, cam_label)
    feat_last, feat, feat_proj = x_last[:, 0], x_post[:, 0], x_proj[:, 0]
    fbn = bnneck_apply(model.bottleneck, feat, training=True)
    fpbn = bnneck_apply(model.bottleneck_proj, feat_proj, training=True)
    scores = [F.linear(fbn, model.classifier.weight),
              F.linear(fpbn, model.classifier_proj.weight)]
    return scores, [feat_last, feat, feat_proj], feat_proj


def clipreid_forward_eval(model: ClipReID, images: torch.Tensor,
                          cam_label=None) -> torch.Tensor:
    """→ [B, width + proj_dim] fp32: the ln_post and projected CLS, before
    or after their BNNecks (TEST.NECK_FEAT 'before' / 'after')."""
    _, x_post, x_proj = _image_triple(model, images, cam_label)
    feat, feat_proj = x_post[:, 0], x_proj[:, 0]
    if model.spec.neck_feat == "after":
        feat = bnneck_apply(model.bottleneck, feat, training=False)
        feat_proj = bnneck_apply(model.bottleneck_proj, feat_proj, training=False)
    # a compute-dtype and an fp32 tensor: the join is fp32, as jnp.concatenate
    return torch.cat([feat.float(), feat_proj], dim=1)

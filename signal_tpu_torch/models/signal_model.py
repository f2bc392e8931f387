"""The Signal model (port of `signal_tpu/models/signal_model.py`).

Shared CLIP ViT-B/16 encoder over the three modalities (folded into one
[3B, …] batch, sample-major) → SIM → features before the BNNecks (eval),
or → SIM, GAM/LAM and the BNNeck + classifier heads (training).

The tower's variants: MODEL.ADAPTER, MODEL.PROMPT (three prompted
per-modality streams instead of the folded batch), MODEL.FROZEN (LoRA
factors merged into the frozen tower's kernels) and MODEL.MOE_EXPERTS > 1
(routed expert MLPs, whose load-balance aux the train loss weighs).

The ``Signal`` module holds every parameter of the reference ``Signal``
under the reference's state-dict names (`modeling/make_model.py` in
maxingan2412/Signal; the keys `signal_tpu/models/clip_loader.py::
export_reference_signal_state_dict` writes), so a reference checkpoint and
a converted JAX tree both load with ``strict=True``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from signal_tpu_torch.models.align import AlignM, align_forward
from signal_tpu_torch.models.bnneck import BNNeck, bnneck_apply
from signal_tpu_torch.models.sim import SIM, sim_forward
from signal_tpu_torch.models.lora import init_lora_factors, lora_modules
from signal_tpu_torch.models.vit import VisionTransformer, vit_forward
from signal_tpu_torch.models.vit_prompt import MODALITY_ORDER, vit_forward_prompt
from signal_tpu_torch.ops.attention import trunc_normal_

MODALITIES = ("RGB", "NI", "TI")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static model description; field names follow the JAX package's
    ``ModelSpec`` so the same override strings shrink both."""
    num_classes: int
    camera_num: int
    view_num: int = 0
    backbone: str = "clip"
    feat_dim: int = 512          # CLIP ViT-B/16 output dim
    width: int = 768
    layers: int = 12
    num_heads: int = 12
    patch_size: int = 16
    stride_size: int = 16
    h: int = 16                  # patch-grid height ((img_h − 16)/stride + 1)
    w: int = 8                   # patch-grid width
    direct: bool = True
    use_a: bool = True
    use_b: bool = True
    topk: int = 80
    keep_ratio: Optional[float] = None
    sie_camera: bool = True
    sie_view: bool = False
    sie_coe: float = 1.0
    stage: str = "together_CLS_Patch"   # MODEL.stageName: 'CLS' → GAM only
    compute_dtype: str = "bfloat16"
    use_flash: bool = False
    adapter: bool = False        # MODEL.ADAPTER (MambaPro parallel adapter)
    prompt: bool = False         # MODEL.PROMPT (MambaPro prompt tokens)
    frozen: bool = False         # MODEL.FROZEN (tower frozen, LoRA factors train)
    lora_rank: int = 8           # LoRA rank r (alpha fixed at 2r)
    remat: bool = True           # MODEL.REMAT: per-block recompute in the backward
    remat_policy: str = "full"   # MODEL.REMAT_POLICY: full | dots | attn | attn_mlp | half
    miss: str = "nothing"        # TEST.MISS missing-modality eval pattern
    moe_experts: int = 0         # MODEL.MOE_EXPERTS (> 1: routed MoE MLP)
    moe_topk: int = 1            # MODEL.MOE_TOPK
    moe_capacity: float = 1.25   # MODEL.MOE_CAPACITY

    @classmethod
    def from_config(cls, cfg, num_classes: int, camera_num: int,
                    view_num: int = 0) -> "ModelSpec":
        ttype = cfg.MODEL.TRANSFORMER_TYPE
        if "ViT-B-16" not in ttype:
            raise NotImplementedError(
                f"MODEL.TRANSFORMER_TYPE={ttype!r}: only the CLIP ViT-B-16 tower is "
                f"ported; the other backbones are ROADMAP Queue 1 item 4")
        moe_experts = int(cfg.MODEL.MOE_EXPERTS)
        if moe_experts > 1:
            # `signal_tpu/models/signal_model.py:105-129`, its messages
            if cfg.PARALLEL.PIPE_AXIS > 1:
                raise ValueError(
                    "MODEL.MOE_EXPERTS does not compose with "
                    "PARALLEL.PIPE_AXIS > 1 (aux loss / expert all-to-all "
                    "are not threaded through the pipeline schedule)")
            if cfg.MODEL.FROZEN:
                raise ValueError(
                    "MODEL.MOE_EXPERTS does not compose with MODEL.FROZEN "
                    "(LoRA factors target dense 2-D kernels, not expert "
                    "stacks)")
            if cfg.MODEL.PROMPT:
                raise ValueError(
                    "MODEL.MOE_EXPERTS does not compose with MODEL.PROMPT "
                    "(the prompted per-modality forward has no MoE path)")
        if cfg.PARALLEL.MODEL_AXIS > 1 or cfg.PARALLEL.PIPE_AXIS > 1:
            raise NotImplementedError(
                "tensor and pipeline parallelism are not ported yet "
                "(ROADMAP Queue 1 item 6, scale-out)")
        if cfg.PARALLEL.SEQUENCE:
            # as the JAX spec: sequence parallelism shards tokens over the
            # 'model' axis, so without one it does nothing; say so and run
            logging.getLogger("signal_tpu_torch.model").warning(
                "PARALLEL.SEQUENCE=True has no effect with MODEL_AXIS=%d — "
                "Megatron-SP shards tokens over the 'model' axis and "
                "requires MODEL_AXIS > 1 (docs/CONFIG.md)", int(cfg.PARALLEL.MODEL_AXIS))
        # conv-output grid (patch 16, stride may overlap), as in the JAX spec
        h = (cfg.INPUT.SIZE_TRAIN[0] - 16) // cfg.MODEL.STRIDE_SIZE[0] + 1
        w = (cfg.INPUT.SIZE_TRAIN[1] - 16) // cfg.MODEL.STRIDE_SIZE[1] + 1
        return cls(
            num_classes=num_classes,
            camera_num=camera_num,
            view_num=view_num if cfg.MODEL.SIE_VIEW else 0,
            stride_size=int(cfg.MODEL.STRIDE_SIZE[0]),
            h=h,
            w=w,
            direct=bool(cfg.MODEL.DIRECT),
            use_a=bool(cfg.MODEL.USE_A),
            use_b=bool(cfg.MODEL.USE_B),
            topk=int(cfg.MODEL.TOPK),
            keep_ratio=cfg.MODEL.KEEP_RATIO if cfg.MODEL.FIXED_KEEP_RATIO else None,
            sie_camera=bool(cfg.MODEL.SIE_CAMERA),
            sie_view=bool(cfg.MODEL.SIE_VIEW),
            sie_coe=float(cfg.MODEL.SIE_COE),
            stage=cfg.MODEL.stageName.strip(),
            compute_dtype=cfg.MODEL.COMPUTE_DTYPE,
            use_flash=bool(cfg.MODEL.USE_PALLAS_ATTENTION),
            adapter=bool(cfg.MODEL.ADAPTER),
            prompt=bool(cfg.MODEL.PROMPT),
            frozen=bool(cfg.MODEL.FROZEN),
            remat=bool(cfg.MODEL.REMAT),
            remat_policy=str(cfg.MODEL.REMAT_POLICY),
            miss=str(cfg.TEST.MISS),
            moe_experts=moe_experts,
            moe_topk=int(cfg.MODEL.MOE_TOPK),
            moe_capacity=float(cfg.MODEL.MOE_CAPACITY),
        )

    @property
    def cdtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.compute_dtype]

    @property
    def eval_feat_dim(self) -> int:
        return 6 * self.feat_dim if self.use_a else 3 * self.feat_dim

    @property
    def sie_slots(self) -> int:
        """Rows of the SIE table (`meta_arch.py:79-92`): cam×view when both
        flags are set, else camera-only, else view-only; 0 for none."""
        if self.sie_camera and self.sie_view and self.view_num:
            return self.camera_num * self.view_num
        if self.sie_camera:
            return self.camera_num
        if self.sie_view and self.view_num:
            return self.view_num
        return 0


class ClipVisionEncoder(nn.Module):
    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.base = VisionTransformer(
            h_resolution=spec.h, w_resolution=spec.w, patch_size=spec.patch_size,
            width=spec.width, layers=spec.layers, output_dim=spec.feat_dim,
            adapter=spec.adapter, prompt=spec.prompt, moe_experts=spec.moe_experts)
        if spec.frozen:
            init_lora_factors(self.base, rank=spec.lora_rank, alpha=2.0 * spec.lora_rank)
        if spec.sie_slots:
            self.cv_embed = nn.Parameter(torch.zeros(spec.sie_slots, 1, spec.width))
        else:
            self.cv_embed = None


class Signal(nn.Module):
    """The reference ``Signal`` module's parameters; ``forward`` is
    :func:`forward_eval` and :func:`forward_train` the training forward."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        feat = spec.feat_dim
        self.clip_vision_encoder = ClipVisionEncoder(spec)
        if spec.direct:
            self.bottleneck = BNNeck(3 * feat)
            self.classifier = nn.Linear(3 * feat, spec.num_classes, bias=False)
        else:
            for m in ("r", "n", "t"):
                setattr(self, f"bottleneck_{m}", BNNeck(feat))
                setattr(self, f"classifier_{m}", nn.Linear(feat, spec.num_classes, bias=False))
        if spec.use_a:
            self.SIM = SIM(feat)
            self.bottleneck_var = BNNeck(3 * feat)
            self.classifier_var = nn.Linear(3 * feat, spec.num_classes, bias=False)
        if spec.use_b:
            self.AlignM = AlignM(feat)

    def forward(self, imgs, cam_label=None) -> torch.Tensor:
        return forward_eval(self, imgs, cam_label)


def init_signal(spec: ModelSpec, seed: int = 0) -> Signal:
    """A ``Signal`` on the CPU with random weights drawn from a
    ``torch.Generator(seed)``, with the JAX package's init distributions
    (`init_signal_params`): classifiers N(0, 0.001), BNNecks ones and
    zeros, DAS convs U(±1/√fan_in) with zero biases, ``contra_temp`` 0.07.
    Move it with ``.to``."""
    gen = torch.Generator().manual_seed(seed)
    model = Signal(spec)
    with torch.no_grad():
        model.clip_vision_encoder.base.reset_parameters(gen)
        for lora in lora_modules(model.clip_vision_encoder.base) if spec.frozen else ():
            lora.reset_parameters(gen)
        if model.clip_vision_encoder.cv_embed is not None:
            trunc_normal_(model.clip_vision_encoder.cv_embed, gen)
        for name in ("classifier", "classifier_r", "classifier_n", "classifier_t",
                     "classifier_var"):
            if hasattr(model, name):
                getattr(model, name).weight.normal_(0.0, 0.001, generator=gen)
        if spec.use_a:
            model.SIM.reset_parameters(gen)
        if spec.use_b:
            model.AlignM.reset_parameters(gen)
    return model.eval()


def _encode(model: Signal, imgs: torch.Tensor, cam_label, remat: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """imgs [B, 3(modal), 3(ch), H, W] → (patches [B, 3, L, D], cls
    [B, 3, D], moe_aux or None). Under MODEL.FROZEN the tower's kernels
    are read merged with their LoRA factors; MODEL.PROMPT runs three
    prompted per-modality streams, everything else one folded batch."""
    spec = model.spec
    B = imgs.shape[0]
    enc = model.clip_vision_encoder
    cv = None
    if spec.sie_camera and cam_label is not None:
        cv = spec.sie_coe * enc.cv_embed[cam_label, 0]                   # [B, width]
    if spec.prompt:
        outs = [vit_forward_prompt(enc.base, imgs[:, m], cv, name, num_heads=spec.num_heads,
                                   compute_dtype=spec.cdtype, use_flash=spec.use_flash,
                                   stride=spec.stride_size)
                for m, name in enumerate(MODALITY_ORDER)]
        return (torch.stack([o[0] for o in outs], dim=1),
                torch.stack([o[1] for o in outs], dim=1), None)
    x = imgs.reshape(B * 3, *imgs.shape[2:])
    # rows of x are sample-major — (b0,RGB),(b0,NI),(b0,TI),(b1,RGB),… —
    # so each sample's embedding is REPEATED ×3, not tiled
    cv3 = cv.repeat_interleave(3, dim=0) if cv is not None else None
    out = vit_forward(enc.base, x, cv3, num_heads=spec.num_heads,
                      compute_dtype=spec.cdtype, use_flash=spec.use_flash,
                      stride=spec.stride_size, remat=remat,
                      remat_policy=spec.remat_policy, moe_topk=spec.moe_topk,
                      moe_capacity=spec.moe_capacity)
    patches, cls = out[0], out[1]
    L, D = patches.shape[1], patches.shape[2]
    return (patches.reshape(B, 3, L, D), cls.reshape(B, 3, D),
            out[2] if len(out) > 2 else None)


def _stack_modalities(imgs) -> torch.Tensor:
    if not isinstance(imgs, dict):
        return imgs  # already packed [B, 3modal, 3ch, H, W]
    return torch.stack([imgs[m] for m in MODALITIES], dim=1)


def _apply_miss(x: torch.Tensor, miss: str) -> torch.Tensor:
    """Missing-modality eval (TEST.MISS): zero out the named modalities
    ('r'/'n'/'t' combinations, e.g. 'rn')."""
    if not miss or miss.lower() in ("none", "nothing"):
        return x
    keep = torch.ones(3, dtype=x.dtype, device=x.device)
    for ch in miss.lower():
        if ch in "rnt":
            keep["rnt".index(ch)] = 0.0
    return x * keep[None, :, None, None, None]


def forward_eval(model: Signal, imgs: Dict[str, torch.Tensor] | torch.Tensor,
                 cam_label) -> torch.Tensor:
    """Inference features: [B, 3D] (no SIM) or [B, 6D] (with SIM), taken
    BEFORE the BNNecks (TEST.NECK_FEAT='before', `make_model.py:284-290`)."""
    spec = model.spec
    x = _apply_miss(_stack_modalities(imgs), spec.miss)
    patches, cls, _ = _encode(model, x, cam_label)
    ori = cls.reshape(cls.shape[0], -1)
    if not spec.use_a:
        return ori
    vars_total, _ = sim_forward(model.SIM, patches, cls, k=spec.topk,
                                keep_ratio=spec.keep_ratio, compute_dtype=spec.cdtype)
    return torch.cat([ori, vars_total], dim=-1)


def forward_train(model: Signal, imgs: Dict[str, torch.Tensor] | torch.Tensor,
                  cam_label) -> Dict[str, Any]:
    """Training forward (`signal_model.py:459-518`); updates the BNNecks'
    running stats in place. → {'scores': [...], 'feats': [...],
    'gam': scalar | None, 'lam': scalar | None, 'masks': {...} | None,
    'moe_aux': scalar | None}.

    (score, feat) pairs come in the reference's tuple order: DIRECT = 1 →
    the concatenated CLS features [B, 3D]; DIRECT = 0 → one per modality
    (r, n, t); then SIM's fused features when USE_A."""
    spec = model.spec
    patches, cls, moe_aux = _encode(model, _stack_modalities(imgs), cam_label,
                                    remat=spec.remat)
    out: Dict[str, Any] = {"scores": [], "feats": [], "gam": None, "lam": None,
                           "masks": None, "moe_aux": moe_aux}
    vars_total = None
    if spec.use_a:
        vars_total, out["masks"] = sim_forward(model.SIM, patches, cls, k=spec.topk,
                                               keep_ratio=spec.keep_ratio,
                                               compute_dtype=spec.cdtype)
    if spec.use_b:
        out["gam"], out["lam"] = align_forward(model.AlignM, patches, h=spec.h, w=spec.w,
                                               stage=spec.stage)

    def head(bn: str, classifier: str, feat: torch.Tensor) -> None:
        fbn = bnneck_apply(getattr(model, bn), feat, training=True)
        out["scores"].append(F.linear(fbn, getattr(model, classifier).weight))
        out["feats"].append(feat)

    if spec.direct:
        head("bottleneck", "classifier", cls.reshape(cls.shape[0], -1))
    else:
        for i, m in enumerate(("r", "n", "t")):
            head(f"bottleneck_{m}", f"classifier_{m}", cls[:, i])
    if spec.use_a:
        head("bottleneck_var", "classifier_var", vars_total)
    return out

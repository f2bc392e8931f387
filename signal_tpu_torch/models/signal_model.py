"""The Signal model (port of `signal_tpu/models/signal_model.py`).

A shared backbone over the three modalities (folded into one [3B, …]
batch, sample-major) → SIM → features before the BNNecks (eval), or →
SIM, GAM/LAM and the BNNeck + classifier heads (training). The backbone
is MODEL.TRANSFORMER_TYPE's, as in JAX:

* 'ViT-B-16': the CLIP tower (``models/vit.py``) with its variants
  MODEL.ADAPTER, MODEL.PROMPT (three prompted per-modality streams instead
  of the folded batch), MODEL.FROZEN (LoRA factors merged into the frozen
  tower's kernels) and MODEL.MOE_EXPERTS > 1 (routed expert MLPs, whose
  load-balance aux the train loss weighs);
* vit_base_patch16_224 / deit_base, vit_small_patch16_224,
  deit_small_patch16_224: the ImageNet ViT (``models/vit_imagenet.py``),
  with stochastic depth in training and LoRA under MODEL.FROZEN;
* t2t_vit_t_14 / 24: T2T-ViT (``models/t2t.py``), LoRA under FROZEN;
* resnet50 / 101 / 152 and osnet_x1_0 … x0_25: the CNNs
  (``models/resnet.py``, ``models/osnet.py``), whose BatchNorm statistics
  move in ``forward_train`` only.

The ``Signal`` module holds every parameter of the reference ``Signal``
under the reference's state-dict names for the CLIP tower
(`modeling/make_model.py` in maxingan2412/Signal; the keys
`signal_tpu/models/clip_loader.py::export_reference_signal_state_dict`
writes), so a reference checkpoint and a converted JAX tree both load
with ``strict=True``. The other backbones sit under ``base.`` with their
upstream projects' names (timm, torchvision, torchreid): the JAX export
refuses them, so these names are the port's own.
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
from signal_tpu_torch.models.osnet import OSNET_BY_FEAT_DIM, OSNET_VARIANTS, OSNet, \
    osnet_forward
from signal_tpu_torch.models.resnet import RESNET_BLOCK_COUNTS, ResNet, resnet_forward
from signal_tpu_torch.models.t2t import T2TViT, t2t_forward
from signal_tpu_torch.models.vit import VisionTransformer, vit_forward
from signal_tpu_torch.models.vit_imagenet import ImageNetViT, drop_path_masks, \
    imagenet_vit_forward
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
    backbone: str = "clip"       # clip | imagenet | t2t | resnet | osnet
    feat_dim: int = 512          # CLIP ViT-B/16 output dim (the others: width)
    width: int = 768
    layers: int = 12
    num_heads: int = 12
    patch_size: int = 16
    stride_size: int = 16
    h: int = 16                  # patch-grid height ((img_h − 16)/stride + 1)
    w: int = 8                   # patch-grid width
    img_h: int = 0               # input image size (0 ⇒ h·stride, w·stride)
    img_w: int = 0
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
    drop_path: float = 0.0       # ImageNet tower stochastic depth (MODEL.DROP_PATH)
    mlp_ratio: float = 4.0       # ImageNet / T2T MLP hidden ratio
    qk_scale: Optional[float] = None  # ImageNet tower qk-scale override
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
        moe_experts = int(cfg.MODEL.MOE_EXPERTS)
        if moe_experts > 1:
            # `signal_tpu/models/signal_model.py:105-129`, its messages
            if "ViT-B-16" not in ttype:
                raise ValueError(
                    "MODEL.MOE_EXPERTS > 1 is implemented for the CLIP ViT "
                    "tower only (the stacked-block scan carrying the MoE MLP)")
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
        size = cfg.INPUT.SIZE_TRAIN
        h = (size[0] - 16) // cfg.MODEL.STRIDE_SIZE[0] + 1
        w = (size[1] - 16) // cfg.MODEL.STRIDE_SIZE[1] + 1
        # the backbones' shapes (JAX `:157-212`)
        layers, width, heads, mlp_ratio, qk_scale = 12, 768, 12, 4.0, None
        if "ViT-B-16" in ttype:
            backbone, feat_dim = "clip", 512
        elif ttype in ("resnet50", "resnet101", "resnet152"):
            # last stride 1 → a /16 grid of 2048-dim features
            backbone, feat_dim = "resnet", 2048
            h, w = size[0] // 16, size[1] // 16
            layers = int(ttype.removeprefix("resnet"))
        elif ttype.startswith("osnet"):
            backbone = "osnet"
            feat_dim = width = OSNET_VARIANTS[ttype][3]
            h, w = size[0] // 16, size[1] // 16
        elif ttype.startswith("t2t"):
            backbone, feat_dim = "t2t", 384
            width, heads, mlp_ratio = 384, 6, 3.0
            layers = 24 if "24" in ttype else 14
        elif ttype == "vit_small_patch16_224":
            # 768 wide, 8 layers and heads, mlp 3, qk scale 768^-0.5
            backbone, feat_dim = "imagenet", 768
            layers, heads, mlp_ratio, qk_scale = 8, 8, 3.0, 768 ** -0.5
        elif ttype == "deit_small_patch16_224":
            backbone, feat_dim = "imagenet", 384
            width, heads = 384, 6
        else:
            # vit_base_patch16_224 / deit_base
            backbone, feat_dim = "imagenet", 768
        return cls(
            num_classes=num_classes,
            camera_num=camera_num,
            view_num=view_num if cfg.MODEL.SIE_VIEW else 0,
            backbone=backbone,
            feat_dim=feat_dim,
            width=width,
            layers=layers,
            num_heads=heads,
            stride_size=int(cfg.MODEL.STRIDE_SIZE[0]),
            h=h,
            w=w,
            img_h=int(size[0]),
            img_w=int(size[1]),
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
            drop_path=float(cfg.MODEL.DROP_PATH),
            mlp_ratio=mlp_ratio,
            qk_scale=qk_scale,
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
    def image_size(self) -> Tuple[int, int]:
        """The input size. ``img_h``/``img_w`` are trusted only where they
        agree with the h×w grid (a spec shrunk with ``dataclasses.replace``
        keeps them); else the size is rebuilt from the grid, which is exact
        only for non-overlapping patches: with an overlapping stride
        several sizes give one grid, so it raises (JAX `:217-238`)."""
        if self.img_h and \
                (self.img_h - 16) // self.stride_size + 1 == self.h and \
                (self.img_w - 16) // self.stride_size + 1 == self.w:
            return (self.img_h, self.img_w)
        if self.stride_size != 16:
            raise ValueError(
                f"ModelSpec.image_size is ambiguous: img_h/img_w "
                f"({self.img_h}x{self.img_w}) do not match the {self.h}x"
                f"{self.w} grid and stride {self.stride_size} overlaps — "
                f"rebuild the spec with dataclasses.replace(..., img_h=, "
                f"img_w=) instead of relying on reconstruction")
        return (self.h * self.stride_size, self.w * self.stride_size)

    @property
    def attention_kernel(self) -> bool:
        """Whether the backbone's blocks run the attention kernel: the CLIP
        and ImageNet towers under MODEL.USE_PALLAS_ATTENTION, but not with
        a qk-scale override (vit_small), as in JAX; T2T's blocks and the
        CNNs never."""
        return self.use_flash and self.backbone in ("clip", "imagenet") \
            and self.qk_scale is None

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


def build_backbone(spec: ModelSpec) -> nn.Module:
    """The non-CLIP backbone of ``spec`` (JAX `init_signal_params`,
    `:279-312`), with LoRA factors on its kernels under MODEL.FROZEN (the
    ViTs only, as in JAX)."""
    if spec.backbone == "resnet":
        return ResNet(RESNET_BLOCK_COUNTS[spec.layers])
    if spec.backbone == "osnet":
        return OSNet(OSNET_BY_FEAT_DIM[spec.feat_dim])
    camera_num = spec.camera_num if spec.sie_camera else 0
    if spec.backbone == "t2t":
        net = T2TViT(img_size=spec.image_size, embed_dim=spec.width, depth=spec.layers,
                     camera_num=camera_num, mlp_ratio=spec.mlp_ratio)
    elif spec.backbone == "imagenet":
        net = ImageNetViT(img_size=spec.image_size, patch_size=spec.patch_size,
                          stride_size=spec.stride_size, width=spec.width, layers=spec.layers,
                          camera_num=camera_num, view_num=spec.view_num,
                          mlp_ratio=spec.mlp_ratio)
    else:
        raise ValueError(f"unknown backbone {spec.backbone!r}")
    if spec.frozen:
        init_lora_factors(net, rank=spec.lora_rank, alpha=2.0 * spec.lora_rank)
    return net


class Signal(nn.Module):
    """The reference ``Signal`` module's parameters; ``forward`` is
    :func:`forward_eval` and :func:`forward_train` the training forward.
    The CLIP tower lives in ``clip_vision_encoder``, any other backbone in
    ``base``."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        feat = spec.feat_dim
        if spec.backbone == "clip":
            self.clip_vision_encoder = ClipVisionEncoder(spec)
        else:
            self.base = build_backbone(spec)
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
    (`init_signal_params`): the backbone's own, classifiers N(0, 0.001),
    BNNecks ones and zeros, DAS convs U(±1/√fan_in) with zero biases,
    ``contra_temp`` 0.07. Move it with ``.to``."""
    gen = torch.Generator().manual_seed(seed)
    model = Signal(spec)
    with torch.no_grad():
        tower = model.clip_vision_encoder.base if spec.backbone == "clip" else model.base
        tower.reset_parameters(gen)
        for lora in lora_modules(tower) if spec.frozen and hasattr(tower, "lora_paths") else ():
            lora.reset_parameters(gen)
        if spec.backbone == "clip" and model.clip_vision_encoder.cv_embed is not None:
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


def _encode(model: Signal, imgs: torch.Tensor, cam_label, remat: bool = False,
            view_label=None, training: bool = False, drop_masks=None
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """imgs [B, 3(modal), 3(ch), H, W] → (patches [B, 3, L, D], cls
    [B, 3, D], moe_aux or None). Under MODEL.FROZEN a ViT's kernels are
    read merged with their LoRA factors; MODEL.PROMPT runs three prompted
    per-modality streams, everything else one folded batch whose rows are
    sample-major — (b0,RGB),(b0,NI),(b0,TI),(b1,RGB),… — so each sample's
    camera and view are REPEATED ×3, not tiled. ``training`` moves a CNN's
    BatchNorm statistics; ``drop_masks`` (:func:`drop_path_masks` over the
    3B rows) is the ImageNet tower's stochastic depth."""
    spec = model.spec
    B = imgs.shape[0]
    x = imgs.reshape(B * 3, *imgs.shape[2:])
    cams = cam_label.repeat_interleave(3) if cam_label is not None else None
    aux = None
    if spec.backbone == "clip":
        enc = model.clip_vision_encoder
        cv = None
        if spec.sie_camera and cam_label is not None:
            cv = spec.sie_coe * enc.cv_embed[cam_label, 0]                   # [B, width]
        if spec.prompt:
            outs = [vit_forward_prompt(enc.base, imgs[:, m], cv, name,
                                       num_heads=spec.num_heads, compute_dtype=spec.cdtype,
                                       use_flash=spec.use_flash, stride=spec.stride_size)
                    for m, name in enumerate(MODALITY_ORDER)]
            return (torch.stack([o[0] for o in outs], dim=1),
                    torch.stack([o[1] for o in outs], dim=1), None)
        cv3 = cv.repeat_interleave(3, dim=0) if cv is not None else None
        out = vit_forward(enc.base, x, cv3, num_heads=spec.num_heads,
                          compute_dtype=spec.cdtype, use_flash=spec.use_flash,
                          stride=spec.stride_size, remat=remat,
                          remat_policy=spec.remat_policy, moe_topk=spec.moe_topk,
                          moe_capacity=spec.moe_capacity)
        patches, cls = out[0], out[1]
        aux = out[2] if len(out) > 2 else None
    elif spec.backbone == "resnet":
        patches, cls = resnet_forward(model.base, x, training=training,
                                      compute_dtype=spec.cdtype)
    elif spec.backbone == "osnet":
        patches, cls = osnet_forward(model.base, x, training=training,
                                     compute_dtype=spec.cdtype)
    elif spec.backbone == "t2t":
        patches, cls = t2t_forward(model.base, x, cams, sie_xishu=spec.sie_coe,
                                   num_heads=spec.num_heads, compute_dtype=spec.cdtype,
                                   remat=remat)
    else:
        views = view_label.repeat_interleave(3) if view_label is not None else None
        patches, cls = imagenet_vit_forward(
            model.base, x, cams, views, camera_num=spec.camera_num if spec.sie_camera else 0,
            view_num=spec.view_num, sie_xishu=spec.sie_coe, num_heads=spec.num_heads,
            stride_size=spec.stride_size,
            drop_path_rate=spec.drop_path if drop_masks is not None else 0.0,
            drop_masks=drop_masks, compute_dtype=spec.cdtype, use_flash=spec.use_flash,
            qk_scale=spec.qk_scale, remat=remat)
    L, D = patches.shape[1], patches.shape[2]
    return patches.reshape(B, 3, L, D), cls.reshape(B, 3, D), aux


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
                 cam_label, view_label=None) -> torch.Tensor:
    """Inference features: [B, 3D] (no SIM) or [B, 6D] (with SIM), taken
    BEFORE the BNNecks (TEST.NECK_FEAT='before', `make_model.py:284-290`).
    A CNN normalises with its running statistics."""
    spec = model.spec
    x = _apply_miss(_stack_modalities(imgs), spec.miss)
    patches, cls, _ = _encode(model, x, cam_label, view_label=view_label)
    ori = cls.reshape(cls.shape[0], -1)
    if not spec.use_a:
        return ori
    vars_total, _ = sim_forward(model.SIM, patches, cls, k=spec.topk,
                                keep_ratio=spec.keep_ratio, compute_dtype=spec.cdtype)
    return torch.cat([ori, vars_total], dim=-1)


def forward_train(model: Signal, imgs: Dict[str, torch.Tensor] | torch.Tensor,
                  cam_label, view_label=None, *,
                  gen: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """Training forward (`signal_model.py:459-518`); updates the BNNecks'
    running stats in place, and a CNN backbone's BatchNorm statistics. →
    {'scores': [...], 'feats': [...], 'gam': scalar | None, 'lam': scalar |
    None, 'masks': {...} | None, 'moe_aux': scalar | None}.

    The ImageNet tower's stochastic depth at MODEL.DROP_PATH draws its
    masks from ``gen`` (a generator on the batch's device) before the
    blocks; without one it runs without (JAX without an rng).

    (score, feat) pairs come in the reference's tuple order: DIRECT = 1 →
    the concatenated CLS features [B, 3D]; DIRECT = 0 → one per modality
    (r, n, t); then SIM's fused features when USE_A."""
    spec = model.spec
    imgs = _stack_modalities(imgs)
    drop_masks = None
    if gen is not None and spec.backbone == "imagenet" and spec.drop_path > 0:
        drop_masks = drop_path_masks(gen, spec.layers, spec.drop_path, 3 * imgs.shape[0],
                                     imgs.device)
    patches, cls, moe_aux = _encode(model, imgs, cam_label, remat=spec.remat,
                                    view_label=view_label, training=True,
                                    drop_masks=drop_masks)
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

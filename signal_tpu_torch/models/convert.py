"""Weights into the port: a JAX parameter tree or a reference ``.pth``.

``state_dict_from_jax`` is the port's own copy of the mapping in
`signal_tpu/models/clip_loader.py::export_reference_signal_state_dict`: it
takes the JAX package's ``(params, bn_state)`` with numpy leaves and
returns tensors under the reference ``Signal`` names, which the port's
``Signal`` module loads with ``strict=True``. ``load_reference_checkpoint``
loads a reference-named ``.pth`` through the same keys.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from signal_tpu_torch.models.signal_model import Signal

_HEADS = ("bottleneck", "bottleneck_r", "bottleneck_n", "bottleneck_t", "bottleneck_var")
_CLASSIFIERS = ("classifier", "classifier_r", "classifier_n", "classifier_t", "classifier_var")


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1)


def state_dict_from_jax(params: Dict[str, Any], bn_state: Dict[str, Any],
                        spec) -> Dict[str, torch.Tensor]:
    """JAX ``(params, bn_state)`` (numpy leaves, CLIP-tower Signal) →
    {reference ``Signal`` key: fp32 tensor}."""
    base = params["base"]
    blocks = base["blocks"]
    unported = [name for name, present in (
        ("MODEL.ADAPTER", "adapter" in blocks), ("MODEL.MOE_EXPERTS", "moe" in blocks),
        ("MODEL.PROMPT", "prompt" in params), ("MODEL.FROZEN", "lora" in params)) if present]
    if unported or spec.backbone != "clip":
        raise NotImplementedError(
            f"{', '.join(unported) or spec.backbone}: not ported yet "
            f"(ROADMAP Queue 1 items 12-13)")
    a = lambda x: np.asarray(x, dtype=np.float32)  # noqa: E731
    out: Dict[str, np.ndarray] = {}

    pre = "clip_vision_encoder.base."
    out[pre + "conv1.weight"] = _hwio_to_oihw(a(base["conv1"]["kernel"]))
    out[pre + "class_embedding"] = a(base["class_embedding"])
    out[pre + "positional_embedding"] = a(base["positional_embedding"])
    for ln in ("ln_pre", "ln_post"):
        out[pre + f"{ln}.weight"] = a(base[ln]["scale"])
        out[pre + f"{ln}.bias"] = a(base[ln]["bias"])
    out[pre + "proj"] = a(base["proj"])
    for i in range(a(blocks["ln_1"]["scale"]).shape[0]):
        b = pre + f"transformer.resblocks.{i}."
        for ln in ("ln_1", "ln_2"):
            out[b + f"{ln}.weight"] = a(blocks[ln]["scale"][i])
            out[b + f"{ln}.bias"] = a(blocks[ln]["bias"][i])
        attn, mlp = blocks["attn"], blocks["mlp"]
        out[b + "attn.in_proj_weight"] = a(attn["qkv_kernel"][i]).T
        out[b + "attn.in_proj_bias"] = a(attn["qkv_bias"][i])
        out[b + "attn.out_proj.weight"] = a(attn["out_kernel"][i]).T
        out[b + "attn.out_proj.bias"] = a(attn["out_bias"][i])
        out[b + "mlp.c_fc.weight"] = a(mlp["fc_kernel"][i]).T
        out[b + "mlp.c_fc.bias"] = a(mlp["fc_bias"][i])
        out[b + "mlp.c_proj.weight"] = a(mlp["proj_kernel"][i]).T
        out[b + "mlp.c_proj.bias"] = a(mlp["proj_bias"][i])
    if "cv_embed" in params:
        out["clip_vision_encoder.cv_embed"] = a(params["cv_embed"])[:, None, :]

    for name in _HEADS:
        if name in params:
            out[f"{name}.weight"] = a(params[name]["scale"])
            out[f"{name}.bias"] = a(params[name]["bias"])
            out[f"{name}.running_mean"] = a(bn_state[name]["mean"])
            out[f"{name}.running_var"] = a(bn_state[name]["var"])
    for name in _CLASSIFIERS:
        if name in params:
            out[f"{name}.weight"] = a(params[name]["kernel"]).T

    if "SIM" in params:
        sel = params["SIM"]["select"]
        for w in ("W_q", "W_k", "W_v"):
            out[f"SIM.token_selection.{w}.weight"] = a(sel[w]["kernel"]).T
            out[f"SIM.token_selection.{w}.bias"] = a(sel[w]["bias"])
        inter = params["SIM"]["interact"]
        mi = "SIM.modal_interactive"
        ca = inter["cross_attn"]
        out[f"{mi}.cross_attn.in_proj_weight"] = a(ca["qkv_kernel"]).T
        out[f"{mi}.cross_attn.in_proj_bias"] = a(ca["qkv_bias"])
        out[f"{mi}.cross_attn.out_proj.weight"] = a(ca["out_kernel"]).T
        out[f"{mi}.cross_attn.out_proj.bias"] = a(ca["out_bias"])
        for idx, fc in ((0, "fc1"), (2, "fc2")):
            out[f"{mi}.ffn.{idx}.weight"] = a(inter["ffn"][fc]["kernel"]).T
            out[f"{mi}.ffn.{idx}.bias"] = a(inter["ffn"][fc]["bias"])
        for i in (1, 2):
            out[f"{mi}.norm{i}.weight"] = a(inter[f"norm{i}"]["scale"])
            out[f"{mi}.norm{i}.bias"] = a(inter[f"norm{i}"]["bias"])

    if "AlignM" in params:
        al = params["AlignM"]
        out["AlignM.contra_temp"] = a(al["contra_temp"])
        for mod in ("DAS_r", "DAS_n", "DAS_t"):
            d, pfx = al[mod], f"AlignM.{mod}"
            out[f"{pfx}.proj_q.weight"] = _hwio_to_oihw(a(d["proj_q"]["kernel"]))
            out[f"{pfx}.proj_q.bias"] = a(d["proj_q"]["bias"])
            for idx, name in ((0, "off_conv1"), (2, "off_dw")):
                out[f"{pfx}.conv_offset.{idx}.weight"] = _hwio_to_oihw(a(d[name]["kernel"]))
                out[f"{pfx}.conv_offset.{idx}.bias"] = a(d[name]["bias"])
            out[f"{pfx}.conv_offset.4.weight"] = _hwio_to_oihw(a(d["off_out"]["kernel"]))
    return {k: torch.tensor(v) for k, v in out.items()}  # copies: JAX leaves are read-only


def load_reference_checkpoint(model: Signal, path: str) -> Signal:
    """Load a reference-named ``.pth``/``.pt`` state dict (a reference
    ``Signal`` checkpoint, or one exported by
    `scripts/export_torch_checkpoint.py`) into ``model`` with
    ``strict=True``. A DataParallel ``module.`` prefix and BatchNorm's
    ``num_batches_tracked`` counters are dropped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj)
    sd = {k.removeprefix("module."): v for k, v in sd.items()
          if not k.endswith("num_batches_tracked")}
    model.load_state_dict(sd, strict=True)
    return model

"""Weights into the port: a JAX parameter tree or a reference ``.pth``.

``state_dict_from_jax`` is the port's own copy of the mapping in
`signal_tpu/models/clip_loader.py::export_reference_signal_state_dict`: it
takes the JAX package's ``(params, bn_state)`` with numpy leaves and
returns tensors under the reference ``Signal`` names, which the port's
``Signal`` module loads with ``strict=True``. The tower's variants come
across too: the adapter and prompt subtrees under the reference's names
(``adapter_ffn``, ``adapter_prompt_*``, ``adapter_transfer``,
``adapter_{r,n,t}``), and the two the reference has no names for under the
port's own: MoE as ``moe.*`` (`ops/moe.py`) and the LoRA factors as
parametrizations (`models/lora.py`). ``load_reference_checkpoint`` loads
a reference-named ``.pth`` through the same keys.
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
    if spec.backbone != "clip":
        raise NotImplementedError(
            f"backbone {spec.backbone!r}: only the CLIP ViT-B-16 tower is ported "
            f"(ROADMAP Queue 1 item 4, the other backbones)")
    base = params["base"]
    blocks = base["blocks"]
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
    lora = params.get("lora", {}).get("blocks", {})
    prompt = params.get("prompt")
    for i in range(a(blocks["ln_1"]["scale"]).shape[0]):
        b = pre + f"transformer.resblocks.{i}."
        for ln in ("ln_1", "ln_2"):
            out[b + f"{ln}.weight"] = a(blocks[ln]["scale"][i])
            out[b + f"{ln}.bias"] = a(blocks[ln]["bias"][i])
        attn = blocks["attn"]
        kernels = {"attn.in_proj_weight": ("attn", "qkv_kernel"),
                   "attn.out_proj.weight": ("attn", "out_kernel")}
        out[b + "attn.in_proj_bias"] = a(attn["qkv_bias"][i])
        out[b + "attn.out_proj.bias"] = a(attn["out_bias"][i])
        if "moe" in blocks:
            moe = blocks["moe"]
            for name in ("router", "fc_kernel", "fc_bias", "proj_kernel", "proj_bias"):
                out[b + f"moe.{name}"] = a(moe[name][i])
        else:
            kernels.update({"mlp.c_fc.weight": ("mlp", "fc_kernel"),
                            "mlp.c_proj.weight": ("mlp", "proj_kernel")})
            out[b + "mlp.c_fc.bias"] = a(blocks["mlp"]["fc_bias"][i])
            out[b + "mlp.c_proj.bias"] = a(blocks["mlp"]["proj_bias"][i])
        for key, (sub, leaf) in kernels.items():
            w = a(blocks[sub][leaf][i]).T
            factors = lora.get(sub, {}).get(leaf)
            if factors is None:
                out[b + key] = w
                continue
            # MODEL.FROZEN: the base weight and its factors as the LoRA
            # parametrization holds them (`models/lora.py`)
            module, weight = key.rsplit(".", 1)
            lp = b + f"{module}.parametrizations.{weight}."
            out[lp + "original"] = w
            out[lp + "0.lora_A"] = a(factors["lora_A"][i])
            out[lp + "0.lora_B"] = a(factors["lora_B"][i])
            out[lp + "0.lora_scale"] = a(factors["lora_scale"])
        if "adapter" in blocks:
            ad = blocks["adapter"]
            out[b + "adapter_ffn.0.weight"] = a(ad["down_kernel"][i]).T
            out[b + "adapter_ffn.0.bias"] = a(ad["down_bias"][i])
            out[b + "adapter_ffn.2.weight"] = a(ad["up_kernel"][i]).T
            out[b + "adapter_ffn.2.bias"] = a(ad["up_bias"][i])
        if prompt is not None:
            for mod in ("rgb", "nir", "tir"):
                out[b + f"adapter_prompt_{mod}"] = a(prompt[f"prompt_{mod}"][i])
            for tname, ours in (("adapter_transfer", "transfer"), ("adapter_r", "adp_r"),
                                ("adapter_n", "adp_n"), ("adapter_t", "adp_t")):
                m = prompt[ours]
                out[b + f"{tname}.0.weight"] = a(m["fc1_kernel"][i]).T
                out[b + f"{tname}.0.bias"] = a(m["fc1_bias"][i])
                out[b + f"{tname}.3.weight"] = a(m["fc2_kernel"][i]).T
                out[b + f"{tname}.3.bias"] = a(m["fc2_bias"][i])
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

"""Weights into the port: a JAX parameter tree or a reference ``.pth``.

``state_dict_from_jax`` is the port's own copy of the mapping in
`signal_tpu/models/clip_loader.py::export_reference_signal_state_dict`: it
takes the JAX package's ``(params, bn_state)`` with numpy leaves and
returns tensors under the reference ``Signal`` names, which the port's
``Signal`` module loads with ``strict=True``. The CLIP tower's variants
come across too: the adapter and prompt subtrees under the reference's
names (``adapter_ffn``, ``adapter_prompt_*``, ``adapter_transfer``,
``adapter_{r,n,t}``), and the two the reference has no names for under the
port's own: MoE as ``moe.*`` (`ops/moe.py`) and the LoRA factors as
parametrizations (`models/lora.py`). The other backbones, which JAX's
export refuses, map onto ``base.`` under their upstream projects' names
(timm for the ImageNet ViT, the reference's for T2T, torchvision for
ResNet, torchreid for OSNet; the CNNs' BatchNorm statistics from
``bn_state["base"]``), the names the port's importers load through.
``load_reference_checkpoint`` loads a reference-named ``.pth`` through the
same keys. ``clipreid_state_dict_from_jax`` carries a JAX CLIP-ReID tree
into the port's ``ClipReID`` (`models/clipreid.py`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from signal_tpu_torch.models.signal_model import Signal

_HEADS = ("bottleneck", "bottleneck_r", "bottleneck_n", "bottleneck_t", "bottleneck_var")
_CLASSIFIERS = ("classifier", "classifier_r", "classifier_n", "classifier_t", "classifier_var")


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1)


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _kernel(out: Dict[str, np.ndarray], key: str, w: np.ndarray, factors,
            i: Optional[int] = None) -> None:
    """A ``[dout, din]`` weight under ``key``, or, with LoRA ``factors``
    (MODEL.FROZEN; ``i`` the block of stacked ones), its base and factors as
    the parametrization holds them (`models/lora.py`)."""
    if factors is None:
        out[key] = w
        return
    pick = _a if i is None else (lambda t: _a(t)[i])
    module, weight = key.rsplit(".", 1)
    lp = f"{module}.parametrizations.{weight}."
    out[lp + "original"] = w
    out[lp + "0.lora_A"] = pick(factors["lora_A"])
    out[lp + "0.lora_B"] = pick(factors["lora_B"])
    out[lp + "0.lora_scale"] = _a(factors["lora_scale"])


def _vit_blocks(out, pre: str, blocks, lora) -> None:
    """The ImageNet / T2T blocks (stacked JAX leaves) under timm's names."""
    for i in range(_a(blocks["ln_1"]["scale"]).shape[0]):
        b = f"{pre}blocks.{i}."
        for ln, name in (("ln_1", "norm1"), ("ln_2", "norm2")):
            out[b + f"{name}.weight"] = _a(blocks[ln]["scale"][i])
            out[b + f"{name}.bias"] = _a(blocks[ln]["bias"][i])
        for sub, leaf, bias, key in (("attn", "qkv_kernel", "qkv_bias", "attn.qkv"),
                                     ("attn", "out_kernel", "out_bias", "attn.proj"),
                                     ("mlp", "fc_kernel", "fc_bias", "mlp.fc1"),
                                     ("mlp", "proj_kernel", "proj_bias", "mlp.fc2")):
            _kernel(out, b + key + ".weight", _a(blocks[sub][leaf][i]).T,
                    lora.get(sub, {}).get(leaf), i)
            out[b + key + ".bias"] = _a(blocks[sub][bias][i])


def _vit_body(out, base, lora) -> None:
    """Tokens, SIE, blocks and final norm of the ImageNet / T2T towers."""
    pre = "base."
    width = _a(base["cls_token"]).shape[-1]
    out[pre + "cls_token"] = _a(base["cls_token"]).reshape(1, 1, width)
    out[pre + "pos_embed"] = _a(base["pos_embed"])[None]
    if "sie_embed" in base:
        out[pre + "sie_embed"] = _a(base["sie_embed"])[:, None, :]
    out[pre + "norm.weight"] = _a(base["norm"]["scale"])
    out[pre + "norm.bias"] = _a(base["norm"]["bias"])
    _vit_blocks(out, pre, base["blocks"], lora.get("blocks", {}))


def _imagenet(out, base, lora) -> None:
    out["base.patch_embed.proj.weight"] = _hwio_to_oihw(_a(base["patch_embed"]["kernel"]))
    out["base.patch_embed.proj.bias"] = _a(base["patch_embed"]["bias"])
    _vit_body(out, base, lora)


def _t2t(out, base, lora) -> None:
    pre = "base.tokens_to_token."
    t2t, t2t_lora = base["t2t"], lora.get("t2t", {})
    for name, ours in (("attn1", "attention1"), ("attn2", "attention2")):
        tt, p = t2t[name], f"{pre}{ours}."
        for ln in ("norm1", "norm2"):
            out[p + f"{ln}.weight"] = _a(tt[ln]["scale"])
            out[p + f"{ln}.bias"] = _a(tt[ln]["bias"])
        _kernel(out, p + "attn.qkv.weight", _a(tt["qkv_kernel"]).T,
                t2t_lora.get(name, {}).get("qkv_kernel"))
        out[p + "attn.proj.weight"] = _a(tt["proj"]["kernel"]).T
        out[p + "attn.proj.bias"] = _a(tt["proj"]["bias"])
        for fc in ("fc1", "fc2"):
            out[p + f"mlp.{fc}.weight"] = _a(tt["mlp"][fc]["kernel"]).T
            out[p + f"mlp.{fc}.bias"] = _a(tt["mlp"][fc]["bias"])
    out[pre + "project.weight"] = _a(t2t["project"]["kernel"]).T
    out[pre + "project.bias"] = _a(t2t["project"]["bias"])
    _vit_body(out, base, lora)


def _bn(out, key: str, p, s) -> None:
    out[key + ".weight"] = _a(p["scale"])
    out[key + ".bias"] = _a(p["bias"])
    out[key + ".running_mean"] = _a(s["mean"])
    out[key + ".running_var"] = _a(s["var"])


def _resnet(out, p, s) -> None:
    """torchvision's names (`load_torchvision_resnet50`'s mapping)."""
    out["base.conv1.weight"] = _hwio_to_oihw(_a(p["stem"]["conv"]))
    _bn(out, "base.bn1", p["stem"]["bn"], s["stem"]["bn"])
    for si in range(1, 5):
        for bi, (bp, bs) in enumerate(zip(p[f"layer{si}"], s[f"layer{si}"])):
            pre = f"base.layer{si}.{bi}."
            for ci in (1, 2, 3):
                out[pre + f"conv{ci}.weight"] = _hwio_to_oihw(_a(bp[f"conv{ci}"]))
                _bn(out, pre + f"bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
            if "down_conv" in bp:
                out[pre + "downsample.0.weight"] = _hwio_to_oihw(_a(bp["down_conv"]))
                _bn(out, pre + "downsample.1", bp["down_bn"], bs["down_bn"])


def _osnet(out, p, s) -> None:
    """torchreid's names (`load_torchreid_osnet`'s mapping)."""
    def cbr(key, cp, cs):
        out[key + ".conv.weight"] = _hwio_to_oihw(_a(cp["conv"]))
        _bn(out, key + ".bn", cp["bn"], cs["bn"])

    cbr("base.conv1", p["stem"], s["stem"])
    for si in (1, 2, 3):
        sp, ss, t = p[f"stage{si}"], s[f"stage{si}"], f"base.conv{si + 1}"
        for bi, (bp, bs) in enumerate(zip(sp["blocks"], ss["blocks"])):
            pre = f"{t}.{bi}."
            cbr(pre + "conv1", bp["conv1"], bs["conv1"])
            for ti, (lights, lights_s) in enumerate(zip(bp["branches"], bs["branches"])):
                name = "conv2" + "abcd"[ti]
                for li, (lp, ls) in enumerate(zip(lights, lights_s)):
                    sub = pre + (name if ti == 0 else f"{name}.{li}")
                    out[sub + ".conv1.weight"] = _hwio_to_oihw(_a(lp["pw"]))
                    out[sub + ".conv2.weight"] = _hwio_to_oihw(_a(lp["dw"]))
                    _bn(out, sub + ".bn", lp["bn"], ls["bn"])
            g = bp["gate"]
            for fc in ("fc1", "fc2"):
                out[pre + f"gate.{fc}.weight"] = _a(g[f"{fc}_kernel"]).T[:, :, None, None]
                out[pre + f"gate.{fc}.bias"] = _a(g[f"{fc}_bias"])
            cbr(pre + "conv3", bp["conv3"], bs["conv3"])
            if "down" in bp:
                cbr(pre + "downsample", bp["down"], bs["down"])
        if "trans" in sp:
            cbr(f"{t}.{len(sp['blocks'])}.0", sp["trans"], ss["trans"])
    cbr("base.conv5", p["conv5"], s["conv5"])


def state_dict_from_jax(params: Dict[str, Any], bn_state: Dict[str, Any],
                        spec) -> Dict[str, torch.Tensor]:
    """JAX ``(params, bn_state)`` (numpy leaves) → {port ``Signal`` key:
    fp32 tensor}, for every backbone."""
    out: Dict[str, np.ndarray] = {}
    if spec.backbone == "imagenet":
        _imagenet(out, params["base"], params.get("lora", {}))
    elif spec.backbone == "t2t":
        _t2t(out, params["base"], params.get("lora", {}))
    elif spec.backbone == "resnet":
        _resnet(out, params["base"], bn_state["base"])
    elif spec.backbone == "osnet":
        _osnet(out, params["base"], bn_state["base"])
    else:
        _clip(out, params)
    _heads(out, params, bn_state)
    return {k: torch.tensor(v) for k, v in out.items()}  # copies: JAX leaves are read-only


def _clip(out: Dict[str, np.ndarray], params) -> None:
    """The CLIP tower and its SIE table under the reference's names."""
    _clip_tower(out, "clip_vision_encoder.base.", params["base"],
                params.get("lora", {}).get("blocks", {}), params.get("prompt"))
    if "cv_embed" in params:
        out["clip_vision_encoder.cv_embed"] = _a(params["cv_embed"])[:, None, :]


def _clip_tower(out, pre: str, base, lora=None, prompt=None) -> None:
    """A CLIP image tower (``init_vit_params``' tree) under CLIP's names."""
    a = _a
    out[pre + "conv1.weight"] = _hwio_to_oihw(a(base["conv1"]["kernel"]))
    out[pre + "class_embedding"] = a(base["class_embedding"])
    out[pre + "positional_embedding"] = a(base["positional_embedding"])
    for ln in ("ln_pre", "ln_post"):
        out[pre + f"{ln}.weight"] = a(base[ln]["scale"])
        out[pre + f"{ln}.bias"] = a(base[ln]["bias"])
    out[pre + "proj"] = a(base["proj"])
    _clip_blocks(out, pre, base["blocks"], lora or {}, prompt)


def _clip_blocks(out, pre: str, blocks, lora, prompt) -> None:
    """Stacked ``[layers, …]`` CLIP blocks (the image tower's, with its
    variants, or the text tower's) → one set per block under
    ``{pre}transformer.resblocks.{i}.``, kernels as ``[out, in]``."""
    a = _a
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
            _kernel(out, b + key, a(blocks[sub][leaf][i]).T, lora.get(sub, {}).get(leaf), i)
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


def clipreid_state_dict_from_jax(params: Dict[str, Any],
                                 bn_state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX CLIP-ReID ``(params, bn_state)`` (`init_clipreid_params`' tree,
    numpy leaves) → {port ``ClipReID`` key: tensor}: the image tower under
    ``base.``, the text tower under ``text.`` (CLIP's names, one set per
    block), SIE, the classifiers as ``[C, in]``, the BNNecks with their
    statistics, and the prompt learner's ``cls_ctx`` and buffers (the
    template's ids as int64)."""
    out: Dict[str, np.ndarray] = {}
    _clip_tower(out, "base.", params["base"])
    text = params["text"]
    out["text.token_embedding.weight"] = _a(text["token_embedding"])
    out["text.positional_embedding"] = _a(text["positional_embedding"])
    _clip_blocks(out, "text.", text["blocks"], {}, None)
    out["text.ln_final.weight"] = _a(text["ln_final"]["scale"])
    out["text.ln_final.bias"] = _a(text["ln_final"]["bias"])
    out["text.text_projection"] = _a(text["text_projection"])
    if "cv_embed" in params:
        out["cv_embed"] = _a(params["cv_embed"])
    for name in ("classifier", "classifier_proj"):
        out[f"{name}.weight"] = _a(params[name]["kernel"]).T
    for name in ("bottleneck", "bottleneck_proj"):
        _bn(out, name, params[name], bn_state[name])
    pl = params["prompt_learner"]
    for name in ("cls_ctx", "token_prefix", "token_suffix"):
        out[f"prompt_learner.{name}"] = _a(pl[name])
    out["prompt_learner.tokenized"] = np.asarray(pl["tokenized"], dtype=np.int64)
    return {k: torch.tensor(v) for k, v in out.items()}


def _heads(out: Dict[str, np.ndarray], params, bn_state) -> None:
    """The BNNecks, classifiers, SIM and AlignM (every backbone)."""
    a = _a
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

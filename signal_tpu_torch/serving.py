"""Serving export: the eval forward as a saved ``torch.export`` program
(port of `signal_tpu/serving.py:43-131`).

``export_eval`` traces ``forward_eval`` with the weights and the spec
bound into one ``ExportedProgram``; ``save_exported`` writes it as
``model.pt2`` beside a ``manifest.json`` (input and output signature,
bytes, the device it was traced on, and what the caller adds: uint8 flag,
image size, config file, weight), and ``load_exported`` gives back a
callable with the JAX package's calling convention: ``call(imgs, camids)``
with ``imgs`` a {'RGB', 'NI', 'TI': [B, 3, H, W]} dict.

Two export modes, as in the JAX package: a **symbolic batch**
(``batch=None``, the batch dimension a ``torch.export.Dim``: one artifact
serves any batch) and a **fixed batch** (concrete shapes). Exported on the
card, either keeps the attention kernel in the graph as the registered
operator ``signal_tpu_torch::attention_fwd``; exported on the CPU, either
takes the eager core, as a JAX export off the TPU drops the Pallas kernel.
Here the port departs from JAX's rule, which also drops the kernel for a
symbolic batch: a Pallas kernel picks its tiles from a concrete batch,
while the operator's fake implementation traces any batch and the CUDA
kernel takes any B at run time.

An artifact serves the device it was traced on: ``linear``'s product
differs by device (``ops/attention.py``: the card's fp32-output product,
widened operands on the CPU). JAX's multi-platform ``platforms=`` has no
counterpart, and asking for more than one device raises. An artifact that
holds the kernel loads only where ``signal_tpu_torch`` is installed
(``load_exported`` imports the operator's module); the exported graph also
does not hold the process-wide TF32 flags, so the loaded callable runs
under ``true_fp32()``, as the eager path does where it needs full fp32.

``export_bridged``/``load_exported_bridged`` are not ported: they export a
``torch_bridge`` module, which has no counterpart in the port (ROADMAP
Queue 1 item 4).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

MODALITIES = ("RGB", "NI", "TI")


class ServingModule(nn.Module):
    """(imgs dict, camids) → features, with ``model``'s weights and
    ``spec`` bound (the JAX ``make_serving_fn`` closure). ``normalize``:
    (mean, std) → the module takes raw uint8 crops and runs Normalize on
    the device; None → pre-normalized float images."""

    def __init__(self, model: nn.Module, spec, normalize: Optional[Tuple] = None):
        super().__init__()
        self.model = model
        self.spec = spec
        self.normalize = normalize

    def forward(self, imgs: Dict[str, torch.Tensor], camids: torch.Tensor) -> torch.Tensor:
        from signal_tpu_torch.data.augment import normalize_images
        from signal_tpu_torch.models.signal_model import forward_eval

        if self.normalize is not None:
            imgs = normalize_images(imgs, *self.normalize)
        kept, self.model.spec = self.model.spec, self.spec
        try:
            return forward_eval(self.model, imgs, camids)
        finally:
            self.model.spec = kept


def export_eval(model: nn.Module, spec, *, image_size: Tuple[int, int],
                batch: Optional[int] = None, normalize: Optional[Tuple] = None,
                device) -> torch.export.ExportedProgram:
    """Export the eval forward of ``model`` (moved to ``device``) with
    ``spec``. ``batch=None`` → a symbolic batch dimension; an int → fixed
    shapes. The graph holds the attention kernel's operator when
    ``spec.use_flash`` and ``device`` is a CUDA device, else the eager
    core."""
    targets = [device] if isinstance(device, (str, torch.device)) else list(device)
    if len(targets) != 1:
        raise ValueError(f"an artifact serves the one device it was traced on, got {targets}")
    device = torch.device(targets[0])
    if spec.use_flash and device.type != "cuda":
        spec = dataclasses.replace(spec, use_flash=False)
    module = ServingModule(model.to(device), spec, normalize).eval()

    H, W = image_size
    in_dtype = torch.uint8 if normalize is not None else torch.float32
    # torch.export specialises a dimension of size 1: trace at 2, serve any
    example = 2 if batch is None else int(batch)
    imgs = {m: torch.zeros(example, 3, H, W, dtype=in_dtype, device=device) for m in MODALITIES}
    cams = torch.zeros(example, dtype=torch.int64, device=device)
    dynamic = None
    if batch is None:
        b = torch.export.Dim("b", min=1)
        dynamic = ({m: {0: b} for m in MODALITIES}, {0: b})
    with torch.no_grad():
        return torch.export.export(module, (imgs, cams), dynamic_shapes=dynamic, strict=False)


def _avals(ep: torch.export.ExportedProgram, names: Sequence[str]):
    """'uint8[b,3,256,128]'-style signatures of the graph's named nodes
    (the one symbolic dimension, the batch, printed as 'b')."""
    nodes = {n.name: n for n in ep.graph.nodes}
    out = []
    for name in names:
        val = nodes[name].meta["val"]
        dims = ",".join(str(d) if isinstance(d, int) else "b" for d in val.shape)
        out.append(f"{str(val.dtype).removeprefix('torch.')}[{dims}]")
    return out


def save_exported(ep: torch.export.ExportedProgram, path: str, *,
                  extra_manifest: Optional[dict] = None) -> str:
    """Write ``model.pt2`` + ``manifest.json`` under ``path``."""
    os.makedirs(path, exist_ok=True)
    blob = os.path.join(path, "model.pt2")
    torch.export.save(ep, blob)
    sig = ep.graph_signature
    first = next(n for n in ep.graph.nodes if n.name in sig.user_inputs)
    manifest = {
        "format": "torch.export.ExportedProgram",
        "torch_version": torch.__version__,
        "device": str(first.meta["val"].device),
        "in_avals": _avals(ep, sig.user_inputs),
        "out_avals": _avals(ep, sig.user_outputs),
        "bytes": os.path.getsize(blob),
    }
    manifest.update(extra_manifest or {})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def load_exported(path: str):
    """Load an artifact directory → (callable, manifest). The callable
    takes (imgs dict, camids) like the exported module."""
    import signal_tpu_torch.ops.flash_attention  # noqa: F401  registers the kernel's operator
    from signal_tpu_torch.ops.attention import true_fp32

    module = torch.export.load(os.path.join(path, "model.pt2")).module()
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def call(imgs: Dict[str, torch.Tensor], camids: torch.Tensor) -> torch.Tensor:
        with true_fp32(), torch.inference_mode():
            return module(imgs, camids)

    return call, manifest

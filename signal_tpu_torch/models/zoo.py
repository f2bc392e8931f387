"""The reference CNN zoo as torch modules (port of
`signal_tpu/models/zoo.py`).

The reference vendors 22 torchreid-derived CNN definitions under
`modeling/backbones/basic_cnn_params/` (maxingan2412/Signal) that its
Signal factory never reaches. ResNet and OSNet are native backbones of the
port (``models/resnet.py``, ``models/osnet.py``); this module covers the
rest: point ``build_zoo_backbone`` at a directory of torchreid-style model
files (a reference checkout's ``modeling/backbones/basic_cnn_params``, or
torchreid's ``torchreid/models``) and it imports the definition, builds
the net, loads a state dict into it and returns the torch module. The JAX
package lowers that module to JAX through ``torch_bridge.py``; the port
runs it as it is, so the bridge has no counterpart here.

``ZOO`` mirrors the reference inventory, one row per member with its
factory name, constructor quirks and the input geometry each net asserts
or assumes (``cal.py`` is left out: its classifier cannot take the
features its trunk emits, so it fails in the reference too).
"""

from __future__ import annotations

import importlib.util
import inspect
import os
import sys
import warnings
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["ZOO", "ZooEntry", "load_zoo_module", "build_zoo_backbone"]


@dataclass(frozen=True)
class ZooEntry:
    file: str                       # source file under the zoo dir
    factory: str                    # factory function or class name
    input_hw: Tuple[int, int]       # a valid (H, W); most nets accept any
    feat_dim: int                   # eval-mode output feature width
    kwargs: Dict = field(default_factory=dict)
    fixed_input: bool = False       # net asserts/requires exactly input_hw
    notes: str = ""


# feat_dim = eval-forward output width at num_classes=NUM (classifier
# logits for nets returning scores; pooled features for torchreid-style
# nets, which return features in eval via `if not self.training`).
ZOO: Dict[str, ZooEntry] = {
    "densenet121": ZooEntry("densenet.py", "densenet121", (256, 128), 1024),
    "densenet169": ZooEntry("densenet.py", "densenet169", (256, 128), 1664),
    "densenet201": ZooEntry("densenet.py", "densenet201", (256, 128), 1920),
    "densenet161": ZooEntry("densenet.py", "densenet161", (256, 128), 2208),
    "densenet121_fc512": ZooEntry("densenet.py", "densenet121_fc512",
                                  (256, 128), 512),
    "se_resnet50": ZooEntry("senet.py", "se_resnet50", (256, 128), 2048),
    "se_resnet101": ZooEntry("senet.py", "se_resnet101", (256, 128), 2048),
    "se_resnet152": ZooEntry("senet.py", "se_resnet152", (256, 128), 2048),
    "se_resnet50_fc512": ZooEntry("senet.py", "se_resnet50_fc512",
                                  (256, 128), 512),
    "se_resnext50_32x4d": ZooEntry("senet.py", "se_resnext50_32x4d",
                                   (256, 128), 2048),
    "se_resnext101_32x4d": ZooEntry("senet.py", "se_resnext101_32x4d",
                                    (256, 128), 2048),
    "senet154": ZooEntry("senet.py", "senet154", (256, 128), 2048),
    "mobilenetv2_x1_0": ZooEntry("mobilenetv2.py", "mobilenetv2_x1_0",
                                 (256, 128), 1280),
    "mobilenetv2_x1_4": ZooEntry("mobilenetv2.py", "mobilenetv2_x1_4",
                                 (256, 128), 1792),
    "shufflenet": ZooEntry("shufflenet.py", "shufflenet", (256, 128), 960),
    "shufflenet_v2_x0_5": ZooEntry("shufflenetv2.py", "shufflenet_v2_x0_5",
                                   (256, 128), 1024),
    "shufflenet_v2_x1_0": ZooEntry("shufflenetv2.py", "shufflenet_v2_x1_0",
                                   (256, 128), 1024),
    "shufflenet_v2_x1_5": ZooEntry("shufflenetv2.py", "shufflenet_v2_x1_5",
                                   (256, 128), 1024),
    "shufflenet_v2_x2_0": ZooEntry("shufflenetv2.py", "shufflenet_v2_x2_0",
                                   (256, 128), 2048),
    "squeezenet1_0": ZooEntry("squeezenet.py", "squeezenet1_0",
                              (256, 128), 512),
    "squeezenet1_1": ZooEntry("squeezenet.py", "squeezenet1_1",
                              (256, 128), 512),
    "squeezenet1_0_fc512": ZooEntry("squeezenet.py", "squeezenet1_0_fc512",
                                    (256, 128), 512),
    "xception": ZooEntry("xception.py", "xception", (256, 128), 2048),
    "inceptionv4": ZooEntry("inceptionv4.py", "inceptionv4",
                            (299, 299), 1536),
    "inceptionresnetv2": ZooEntry("inceptionresnetv2.py",
                                  "inceptionresnetv2", (299, 299), 1536),
    "nasnetamobile": ZooEntry("nasnet.py", "nasnetamobile", (224, 224), 1056),
    "mlfn": ZooEntry("mlfn.py", "mlfn", (256, 128), 768),
    # PCB eval path returns the pre-reduction 2048-d part features
    "pcb_p6": ZooEntry("pcb.py", "pcb_p6", (256, 128), 2048 * 6),
    "pcb_p4": ZooEntry("pcb.py", "pcb_p4", (256, 128), 2048 * 4),
    "resnet50mid": ZooEntry("resnetmid.py", "resnet50mid", (256, 128), 3072),
    # osnet_ain factories pin feature_dim=512 (fc head) at every width
    "osnet_ain_x1_0": ZooEntry("osnet_ain.py", "osnet_ain_x1_0",
                               (256, 128), 512),
    "osnet_ain_x0_75": ZooEntry("osnet_ain.py", "osnet_ain_x0_75",
                                (256, 128), 512),
    "osnet_ain_x0_5": ZooEntry("osnet_ain.py", "osnet_ain_x0_5",
                               (256, 128), 512),
    "osnet_ain_x0_25": ZooEntry("osnet_ain.py", "osnet_ain_x0_25",
                                (256, 128), 512),
    "resnet50_ibn_a": ZooEntry("resnet_ibn_a.py", "resnet50_ibn_a",
                               (256, 128), 2048, kwargs={"last_stride": 1}),
    "resnet50_ibn_b": ZooEntry("resnet_ibn_b.py", "resnet50_ibn_b",
                               (256, 128), 2048, kwargs={"last_stride": 1}),
    "hacnn": ZooEntry("hacnn.py", "HACNN", (160, 64), 1024 + 4 * 128,
                      kwargs={"use_gpu": False}, fixed_input=True,
                      notes="asserts 160x64 input (hacnn.py:308); "
                            "use_gpu=False avoids the hard-coded "
                            ".cuda() at hacnn.py:304"),
    "mudeep": ZooEntry("mudeep.py", "MuDeep", (256, 128), 768,
                       fixed_input=True,
                       notes="fc layer hard-codes the 256x128 "
                             "flatten size (mudeep.py:189)"),
}


def load_zoo_module(zoo_dir: str, filename: str):
    """Import one torchreid-style model file by path (registering nothing
    on sys.path; repeated loads are cached by absolute path)."""
    path = os.path.abspath(os.path.join(zoo_dir, filename))
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"zoo file {path} not found — point zoo_dir at a torchreid "
            "models directory or a Signal-reference "
            "modeling/backbones/basic_cnn_params checkout")
    mod_name = "signal_tpu_torch_zoo_" + filename.replace(".py", "")
    cached = sys.modules.get(mod_name)
    if cached is not None and getattr(cached, "__file__", None) == path:
        return cached
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        # never cache a half-executed module: a retry must re-raise the
        # real import error, not AttributeError on the missing factory
        sys.modules.pop(mod_name, None)
        raise
    return mod


def build_zoo_backbone(name: str, zoo_dir: Optional[str] = None, *,
                       num_classes: int = 1000, state_dict: Optional[dict] = None,
                       train_mode: bool = False):
    """Build a zoo CNN as a torch module, in train mode (batch-statistics
    BatchNorm, dropout on, torchreid-style logits) when ``train_mode``,
    else in eval mode. ``zoo_dir`` defaults to the ``SIGNAL_ZOO_DIR``
    environment variable. ``state_dict`` (a torch state dict, e.g.
    torchreid's pretrained weights; a ``module.`` prefix is dropped) loads
    non-strictly, since a checkpoint may carry its own classifier, but a
    load that matches none of the module's keys raises, and missing keys
    warn."""
    entry = ZOO.get(name)
    if entry is None:
        raise KeyError(f"unknown zoo backbone {name!r}; have {sorted(ZOO)}")
    zoo_dir = zoo_dir or os.environ.get("SIGNAL_ZOO_DIR")
    if not zoo_dir:
        raise ValueError("pass zoo_dir= or set SIGNAL_ZOO_DIR")
    factory = getattr(load_zoo_module(zoo_dir, entry.file), entry.factory)
    sig = inspect.signature(factory)
    kwargs = dict(entry.kwargs)
    if "num_classes" in sig.parameters:
        kwargs.setdefault("num_classes", num_classes)
    if "loss" in sig.parameters:
        kwargs.setdefault("loss", "softmax")
    if "pretrained" in sig.parameters:
        kwargs.setdefault("pretrained", False)
    model = factory(**kwargs)
    if state_dict is not None:
        sd = {k.replace("module.", ""): v for k, v in state_dict.items()}
        # count the real key intersection: torch does not report
        # BatchNorm's num_batches_tracked as missing
        own = set(model.state_dict())
        if not own & set(sd):
            raise ValueError(
                f"state_dict matched 0 of {len(own)} keys for {name!r} "
                f"(first ckpt keys: {list(sd)[:3]}) — wrong checkpoint "
                "or an unstripped prefix")
        result = model.load_state_dict(sd, strict=False)
        if result.missing_keys:
            warnings.warn(f"{name}: {len(result.missing_keys)} of {len(own)} keys not in "
                          f"checkpoint (e.g. {result.missing_keys[:3]})")
    return model.train(train_mode)

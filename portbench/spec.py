"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root, one file
per configuration (``configs/<name>.json``), per traffic mix
(``traffic/<name>.json``) and per per-layer metric (``metrics/<name>.py``),
each found by the name the cell gives.

A configuration file holds the published recipe as it is (``published``:
the YAML of maxingan2412/Signal's ``configs/<DATASET>/Signal.yml``), the
port's own knobs the recipe leaves at their defaults (``port``), the
published tower's sizes (``architecture``), the sizes a dataset fixes and
the benchmark assumes (``assumed``), and the limits of the comparison
that decides ``correct`` by traffic kind (``limits``). Both the port's
config and the plain reference's sizes are read from it; neither reads
the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    per_layer: List[dict]        # the per-layer metrics this cell reports
    end_to_end: List[dict]       # the end-to-end metrics this cell reports

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)])


def _merged(config: dict) -> dict:
    """``published`` with ``port`` laid over it, section by section."""
    out = json.loads(json.dumps(config["published"]))
    for key, value in config.get("port", {}).items():
        if isinstance(value, dict):
            out.setdefault(key, {}).update(value)
        else:
            out[key] = value
    return out


def port_overrides(config: dict) -> List[str]:
    """The configuration as the port's ``merge_from_list`` takes it: KEY
    VALUE pairs, each value a Python literal."""
    opts: List[str] = []

    def walk(prefix: str, node) -> None:
        for key, value in node.items():
            path = f"{prefix}{key}"
            if isinstance(value, dict):
                walk(path + ".", value)
            else:
                opts.extend([path, repr(tuple(value) if isinstance(value, list) else value)])

    walk("", _merged(config))
    return opts


def reference_arch(config: dict, *, train: bool) -> Dict:
    """The sizes and switches the plain reference and the yardstick read,
    from the configuration file alone."""
    m = _merged(config)
    model, inp, solver, a = m["MODEL"], m["INPUT"], m["SOLVER"], config["architecture"]
    size = inp["SIZE_TRAIN"] if train else inp["SIZE_TEST"]
    stride = model["STRIDE_SIZE"][0]
    h = (size[0] - a["patch"]) // stride + 1
    w = (size[1] - a["patch"]) // stride + 1
    return {
        "width": a["width"], "layers": a["layers"], "heads": a["heads"], "patch": a["patch"],
        "feat_dim": a["feat_dim"], "mlp_ratio": a["mlp_ratio"], "sim_heads": a["sim_heads"],
        "stride": stride, "h": h, "w": w, "img_h": size[0], "img_w": size[1],
        "direct": bool(model["DIRECT"]), "use_a": bool(model["USE_A"]),
        "use_b": bool(model["USE_B"]), "topk": int(model["TOPK"]),
        "sie_camera": bool(model["SIE_CAMERA"]), "sie_coe": float(model["SIE_COE"]),
        "stage": model["stageName"].strip(),
        "num_classes": config["assumed"]["num_classes"],
        "camera_num": config["assumed"]["camera_num"],
    }


def recipe(config: dict) -> Dict:
    """The train and test recipe's numbers the reference reads."""
    m = _merged(config)
    model, inp, solver, dl = m["MODEL"], m["INPUT"], m["SOLVER"], m["DATALOADER"]
    return {
        "batch_train": int(solver["IMS_PER_BATCH"]), "num_instance": int(dl["NUM_INSTANCE"]),
        "batch_test": int(m["TEST"]["IMS_PER_BATCH"]),
        "base_lr": float(solver["BASE_LR"]), "bias_lr_factor": float(solver["BIAS_LR_FACTOR"]),
        "weight_decay": float(solver["WEIGHT_DECAY"]),
        "weight_decay_bias": float(solver["WEIGHT_DECAY_BIAS"]),
        "large_fc_lr": bool(solver["LARGE_FC_LR"]), "dataset": m["DATASETS"]["NAMES"],
        "id_w": float(model["ID_LOSS_WEIGHT"]), "tri_w": float(model["TRIPLET_LOSS_WEIGHT"]),
        "gram_w": float(model["Gram_Loss_weight"]), "pat_w": float(model["PAT_Loss_weight"]),
        "no_margin": bool(model["NO_MARGIN"]), "margin": float(solver["MARGIN"]),
        "label_smooth": model["IF_LABELSMOOTH"] == "on",
        "mean": tuple(inp["PIXEL_MEAN"]), "std": tuple(inp["PIXEL_STD"]),
        "flip_prob": float(inp["PROB"]), "re_prob": float(inp["RE_PROB"]),
        "padding": int(inp["PADDING"]),
    }


def subseed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose (weights, images, labels, augment,
    the sample that is checked), drawn from the run's ``--seed``: any
    whole number, beyond 32 bits too."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def limits(config: dict, kind: str) -> Optional[Dict[str, float]]:
    return config.get("limits", {}).get(kind)

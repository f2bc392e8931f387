"""BENCHMARK.json and the files it names: they parse, keep to the
contract's shapes, and state the published recipes as they are."""

import ast
import json
import re
from pathlib import Path

import pytest
import yaml

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def _names():
    for c in BENCH["configs"]:
        yield c["name"]
        yield from c["reduced"]
    for w in BENCH["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        yield m["name"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        moves = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        # each cell that reports the metric reports what it moves
        assert set(metric["workloads"]) <= set(moves.get("workloads", cells))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader(metric):
    path = ROOT / "portbench" / "metrics" / f"{metric['name']}.py"
    tree = ast.parse(path.read_text())
    defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    imported = {a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom)
                for a in n.names}
    assert "read" in defined | imported


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    def reports(m):
        return cell["name"] in m.get("workloads", [cell["name"]])

    e2e = [m["name"] for m in BENCH["end_to_end"] if reports(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m) for m in BENCH["per_layer"])
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    assert (ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").exists()


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_the_published_recipe(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == []
    dataset = data["published"]["DATASETS"]["NAMES"]
    assert data["published"] == yaml.safe_load((ROOT / "configs" / dataset /
                                                "Signal.yml").read_text())
    # the published ViT-B/16
    assert {k: data["architecture"][k] for k in ("width", "layers", "heads", "patch",
                                                 "feat_dim")} == \
        {"width": 768, "layers": 12, "heads": 12, "patch": 16, "feat_dim": 512}
    for kind in ("train", "gallery"):
        assert data["limits"][kind], f"{config['name']} has no {kind} limits"


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads_into_the_port(config):
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.models.signal_model import ModelSpec

    from portbench import spec

    data = json.loads((ROOT / config["file"]).read_text())
    cfg = load_config(None, spec.port_overrides(data))
    mspec = ModelSpec.from_config(cfg, data["assumed"]["num_classes"],
                                  data["assumed"]["camera_num"])
    arch = spec.reference_arch(data, train=True)
    assert (mspec.h, mspec.w, mspec.topk, mspec.direct) == \
        (arch["h"], arch["w"], arch["topk"], arch["direct"])
    assert mspec.h * mspec.w + 1 == 129
    assert cfg.MODEL.COMPUTE_DTYPE == "bfloat16" and cfg.MODEL.REMAT_POLICY == "full"


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "traffic").glob("*.json")),
                         ids=lambda p: p.name)
def test_traffic_files_parse(path):
    data = json.loads(path.read_text())
    assert data["kind"] in ("train", "gallery")
    assert (ROOT / "portbench" / "kinds" / f"{data['kind']}.py").exists()
    assert NAME.match(path.stem)

"""The T2T gallery cell's own files on the CPU: the reference's parameters
against the port's state dict at the cell's configuration, the frozen
FLOP count against the port's, the token attention's readers on a
hand-made trace, and the kind's run at a toy size, sound and faulty."""

import json
import math
import time
from pathlib import Path

import pytest
import torch

from portbench import correct, harness, readers, spec, t2t_yardstick
from portbench.calibrate_t2t import WORKLOAD, control_numbers, plant
from portbench.reference import t2t
from portbench.trace import DeviceOp, HostOp, Trace

ROOT = Path(__file__).resolve().parent.parent.parent
ROUNDING = 1e-4     # float32 against float32: summation order only
METRICS = ROOT / "portbench" / "metrics"


def _cell():
    return spec.load_cell(ROOT, WORKLOAD)


def test_reference_parameters_are_the_ports_state_dict():
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.models.signal_model import ModelSpec, Signal

    data = _cell().config
    arch = t2t.reference_arch(data, train=False)
    mspec = ModelSpec.from_config(load_config(None, spec.port_overrides(data)),
                                  arch["num_classes"], arch["camera_num"])
    assert (mspec.backbone, mspec.width, mspec.layers, mspec.num_heads, mspec.feat_dim) == \
        ("t2t", 384, 14, 6, 384)
    with torch.device("meta"):
        port = Signal(mspec)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    shapes = t2t.param_shapes(arch)
    assert len(shapes) == len(dict(shapes))
    assert dict(shapes) == want
    tower = sum(int(torch.tensor(s).prod()) for n, s in shapes if n.startswith("base."))
    assert 21e6 < tower < 22e6          # the published t2t_vit_t_14 tower, 21.5 M


def test_sinusoid_table_is_the_ports():
    from signal_tpu_torch.models.t2t import sinusoid_pos_embed

    torch.testing.assert_close(t2t.sinusoid_table(129, 384), sinusoid_pos_embed(129, 384),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("batch", [1, 64, 128])
def test_frozen_flops_equal_the_ports(batch):
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.models.signal_model import ModelSpec
    from signal_tpu_torch.utils.flops import signal_analytic_flops

    data = _cell().config
    arch = t2t.reference_arch(data, train=False)
    mspec = ModelSpec.from_config(load_config(None, spec.port_overrides(data)),
                                  arch["num_classes"], arch["camera_num"])
    assert mspec.backbone == "t2t"
    for train in (False, True):
        assert t2t_yardstick.signal_flops(arch, batch, train=train) == \
            signal_analytic_flops(mspec, batch, train=train)


def test_token_attention_cost_at_the_gallery_shapes():
    # B 128 triplets: 384 rows of one 64-wide head at 2,048 and 512 tokens
    ops, nbytes = t2t_yardstick.token_attention_cost([384, 2048, 64], [384, 2048, 64])
    assert ops == 4 * 384 * 2048 ** 2 * 64 and nbytes == 4 * 4 * 384 * 2048 * 64
    ops2, _ = t2t_yardstick.token_attention_cost([384, 512, 64], [384, 512, 64])
    # 0.44 TFLOP a batch: 2.7 ms at the fp32-accurate tensor-core rate
    assert (ops + ops2) / 1e12 == pytest.approx(0.4381, rel=1e-3)
    assert (ops + ops2) / (495e12 / 3) == pytest.approx(2.655e-3, rel=1e-3)


def _read(name, ctx):
    import importlib.util

    loader = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod.read(ctx)


def _ctx(calls):
    """A window of two batches with ``calls`` (q shape, device µs) of the
    operator, each under its host event, and one other kernel."""
    ops, host = [], []
    for i, (shape, us) in enumerate(calls):
        op = HostOp(t2t_yardstick.TOKEN_ATTENTION, 100 * i, 100 * i + 90, 1,
                    [shape, shape, shape, []])
        host.append(op)
        ops += [DeviceOp("gemm", 100 * i + 10, us / 2, "kernel", [op]),
                DeviceOp("softmax", 100 * i + 50, us / 2, "kernel", [op])]
    ops.append(DeviceOp("attention_fwd", 5000, 40, "kernel", []))
    trace = Trace(ops, host, 1, {readers.WINDOW_MARK: (0, 10_000)})
    return readers.Readings(unit_flops=1.0, bw=3.35e12, flops=989e12, trace=trace,
                            traced_units=2)


def test_token_attention_readers():
    ctx = _ctx([([384, 2048, 64], 20_000.0), ([384, 512, 64], 1_500.0)])
    assert _read("token_attn_ms.gallery", ctx) == pytest.approx(21.5 / 2)
    least = sum(4.0 * 384 * L * L * 64 / (495e12 / 3) for L in (2048, 512))
    assert _read("token_attn_roofline.gallery", ctx) == pytest.approx(100 * least / 21.5e-3)
    # a program without the operator (the parent) gives nothing to read
    empty = _ctx([])
    assert _read("token_attn_ms.gallery", empty) is None
    assert _read("token_attn_roofline.gallery", empty) is None
    # another card: not these rates
    other = _ctx([([384, 2048, 64], 20_000.0)])
    other.bw = 2.0e12
    assert _read("token_attn_roofline.gallery", other) is None


def _toy_run(limits):
    cell = _cell()
    cfg = json.loads(json.dumps(cell.config))
    cfg["architecture"].update(width=96, layers=2, heads=4, feat_dim=96)
    cfg["published"]["INPUT"].update(SIZE_TRAIN=[64, 64], SIZE_TEST=[64, 64])
    cfg["published"]["MODEL"]["TOPK"] = 3
    cfg["published"]["TEST"]["IMS_PER_BATCH"] = 8
    cfg["assumed"].update(num_classes=8, camera_num=2)
    cfg["port"]["MODEL"].update(DEVICE="cpu", COMPUTE_DTYPE="float32")
    if limits is not None:
        cfg["limits"] = {"gallery": limits}
    traffic = dict(cell.traffic, pool_batches=4)
    toy = spec.Cell(name="toy", chips=1, config=cfg, traffic=traffic, per_layer=[],
                    end_to_end=cell.end_to_end)
    return harness.Run(cell=toy, seed=2 ** 31 + 9, seconds=0.5, trace=False,
                       device=torch.device("cpu"), t_start=time.perf_counter())


def _map_limit():
    return _cell().config["limits"]["gallery"]["t2t_gap"]


def test_a_sound_float32_run_agrees_with_the_reference():
    # the token map is held at the cell's own limit
    res = harness.drive(_toy_run({"feature_gap": ROUNDING, "t2t_gap": _map_limit()}))
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"feature_gap", "t2t_gap"}
    assert set(res["metrics"]) == {"gallery_samples_per_s", "gallery_batch_ms_p95", "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("fault", ["half_batch", "head_scale"])
def test_a_fault_in_the_timed_path_is_not_correct(fault):
    restore = plant(fault)
    try:
        # far above a sound run's rounding; the token map not held
        res = harness.drive(_toy_run({"feature_gap": 1e-2, "t2t_gap": math.inf}))
    finally:
        restore()
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["head_scale", "bf16"])
def test_a_fault_in_the_token_attention_fails_the_token_map_limit(fault):
    """The cell's ``t2t_gap`` limit sees a token attention that runs in bf16
    (TF32 has no CPU route: its reading is the chip's, PERF.md §2), with
    the features not held."""
    restore = plant(fault)
    try:
        res = harness.drive(_toy_run({"feature_gap": math.inf, "t2t_gap": _map_limit()}))
    finally:
        restore()
    assert not res["correct"], res["checks"]
    assert res["checks"]["t2t_gap"]["value"] > _map_limit()


def test_the_float8_control_fails_the_cells_limit():
    run = _toy_run(None)
    ok, checks = correct.verdict(control_numbers(run), spec.limits(run.cell.config, "gallery"))
    assert not ok, checks


def test_config_file_states_the_published_recipe_with_the_t2t_tower():
    """``test_portbench_files.py`` holds every configuration to the
    ViT-B/16 and every traffic file to the two first kinds; the T2T cell's
    files are held here: RGBNT201's published recipe with only its
    TRANSFORMER_TYPE changed, T2T-ViT-t-14's published widths, nothing
    cut, a gallery limit, and a traffic file whose kind has its module in kinds/."""
    import yaml

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["rgbnt201-t2t14-signal"]
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["name"] == entry["name"] and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"] == []
    published = yaml.safe_load((ROOT / "configs/RGBNT201/Signal.yml").read_text())
    published["MODEL"]["TRANSFORMER_TYPE"] = "t2t_vit_t_14"
    assert data["published"] == published
    assert {k: data["architecture"][k] for k in ("width", "layers", "heads", "patch",
                                                 "feat_dim", "mlp_ratio", "token_dim")} == \
        {"width": 384, "layers": 14, "heads": 6, "patch": 16, "feat_dim": 384,
         "mlp_ratio": 3, "token_dim": 64}
    assert set(data["limits"]["gallery"]) == {"feature_gap", "t2t_gap"}
    assert 0 < data["limits"]["gallery"]["t2t_gap"] < data["limits"]["gallery"]["feature_gap"]
    cell = {w["name"]: w for w in bench["workloads"]}[WORKLOAD]
    traffic = json.loads((ROOT / "portbench/traffic" / f"{cell['traffic']}.json").read_text())
    assert traffic["kind"] == "t2t_gallery"
    assert (ROOT / "portbench/kinds/t2t_gallery.py").exists()
    gallery = json.loads((ROOT / "portbench/traffic/gallery-stream.json").read_text())
    assert {k: v for k, v in traffic.items() if k not in ("kind", "why")} == \
        {k: v for k, v in gallery.items() if k not in ("kind", "why")}

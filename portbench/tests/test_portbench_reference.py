"""The plain reference against the port at a toy size on the CPU, and the
comparison that decides ``correct`` against the faults a cell can have.

In float32 the port and the reference compute the same function, so a
sound run's numbers sit at rounding (~1e-6) and every planted fault reads
far above any limit; in the configured bfloat16 a sound run reads at the
compute dtype's rounding, and the float8 control above it."""

import copy
import time

import pytest
import torch

from conftest import toy_cell, toy_run
from portbench import correct, harness, spec
from portbench.calibrate import control_numbers, half_batch_step
from portbench.inputs import make_pool
from portbench.reference import model as ref_model
from portbench.reference import recipe

ROUNDING = 1e-4     # float32 against float32: summation order only


@pytest.mark.parametrize("workload", ["rgbnt201-train", "rgbnt100-train"])
def test_reference_parameters_are_the_ports_state_dict(workload):
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.models.signal_model import ModelSpec, Signal

    data = spec.load_cell(harness.HERE.parent, workload).config
    arch = spec.reference_arch(data, train=True)
    port = Signal(ModelSpec.from_config(load_config(None, spec.port_overrides(data)),
                                        arch["num_classes"], arch["camera_num"]))
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert dict(ref_model.param_shapes(arch)) == want


def test_augment_replays_the_ports_draws():
    from signal_tpu_torch.data.augment import augment_batch, normalize_images

    hp = spec.recipe(toy_cell("train").config)
    arch = spec.reference_arch(toy_cell("train").config, train=True)
    b = make_pool(arch, 8, 1, 5, torch.device("cpu"), num_instance=4)[0]
    u8 = torch.from_numpy(b["packed"])
    x = normalize_images(u8, hp["mean"], hp["std"])
    fill = tuple((0.0 - m) / s for m, s in zip(hp["mean"], hp["std"]))
    port = augment_batch(torch.Generator().manual_seed(9),
                         {"RGB": x[:, 0], "NI": x[:, 1], "TI": x[:, 2]},
                         flip_prob=hp["flip_prob"], re_prob=hp["re_prob"],
                         padding=hp["padding"], fill=fill)
    ours = recipe.augment(torch.Generator().manual_seed(9),
                             recipe.normalize(u8, hp["mean"], hp["std"]), hp)
    for i, m in enumerate(("RGB", "NI", "TI")):
        torch.testing.assert_close(ours[:, i], port[m], rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["train", "gallery"])
def test_a_sound_float32_run_agrees_with_the_reference(kind, monkeypatch):
    run = toy_run(kind, "float32")
    limits = {"loss_gap": ROUNDING, "grad_gap": ROUNDING, "update_gap": ROUNDING,
              "feature_gap": ROUNDING}
    monkeypatch.setitem(run.cell.config, "limits", {kind: limits})
    res = harness.drive(run)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0


def _state_unchanged():
    """Plant the fault: a train step that returns its state unchanged (the
    parameters and Adam's moments as they were before it)."""
    import signal_tpu_torch.engine.train as engine_train

    make = engine_train.make_train_step

    def broken(model, cfg, num_classes, optimizer, **kw):
        step = make(model, cfg, num_classes, optimizer, **kw)

        def unchanged(*a):
            params = {n: p.detach().clone() for n, p in model.named_parameters()}
            moments = copy.deepcopy(optimizer.state_dict())
            out = step(*a)
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(params[n])
            optimizer.load_state_dict(moments)
            return out

        unchanged.stages = step.stages
        return unchanged

    engine_train.make_train_step = broken
    return lambda: setattr(engine_train, "make_train_step", make)


def _eval_fault(kind):
    """Break ``forward_eval`` where the eval step calls it: half of the
    batch left out (the other half's rows repeat the first's), or one
    answer altered (each batch's first row scaled by 1.1)."""
    import signal_tpu_torch.engine.eval as engine_eval

    fwd = engine_eval.forward_eval

    def broken(model, imgs, cams):
        if kind == "half_batch":
            n = imgs.shape[0] // 2
            out = fwd(model, imgs[:n], cams[:n])
            return torch.cat([out, out])[:imgs.shape[0]]
        out = fwd(model, imgs, cams).clone()
        out[0] *= 1.1
        return out

    engine_eval.forward_eval = broken
    return lambda: setattr(engine_eval, "forward_eval", fwd)


@pytest.mark.parametrize("kind,fault", [("train", "state_unchanged"), ("train", "half_batch"),
                                        ("gallery", "half_batch"),
                                        ("gallery", "answer_altered")])
def test_a_fault_in_the_timed_path_is_not_correct(kind, fault, monkeypatch):
    run = toy_run(kind, "float32")
    # limits far above a sound float32 run's rounding (the test above)
    limits = {"loss_gap": 1e-2, "grad_gap": 1e-2, "update_gap": 1e-2, "feature_gap": 1e-2}
    monkeypatch.setitem(run.cell.config, "limits", {kind: limits})
    plant = {"state_unchanged": _state_unchanged, "half_batch": half_batch_step}
    restore = plant[fault]() if kind == "train" else _eval_fault(fault)
    try:
        res = harness.drive(run)
    finally:
        restore()
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kind", ["train", "gallery"])
def test_the_float8_control_fails_the_limits(kind, seed):
    """The control (the reference in float8 in the port's place) at the
    toy size, held to the rgbnt201 cell's limits, is not correct."""
    run = toy_run(kind, seed=seed)
    ok, checks = correct.verdict(control_numbers(run), spec.limits(run.cell.config, kind))
    assert not ok, checks


@pytest.mark.parametrize("workload", ["rgbnt201-train", "rgbnt201-gallery",
                                      "rgbnt100-train", "rgbnt100-gallery"])
@pytest.mark.cuda
def test_the_control_fails_the_limits_on_the_card(workload, cuda_card):
    """On the card at the cell's own size: the float8 control in the port's
    place does not pass the cell's limits."""
    cell = spec.load_cell(harness.HERE.parent, workload)
    run = harness.Run(cell=cell, seed=2 ** 31 + 11, seconds=1, trace=False, device=cuda_card,
                      t_start=time.perf_counter())
    ok, checks = correct.verdict(control_numbers(run), spec.limits(cell.config, cell.kind))
    assert not ok, checks

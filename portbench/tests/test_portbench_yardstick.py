"""The frozen arithmetic on hand-made numbers and traces, and the frozen
FLOP count against the port's own at both configurations."""

import math

import pytest

from portbench import readers, spec, yardstick
from portbench.trace import DeviceOp, HostOp, Trace

H100 = yardstick.peaks("NVIDIA H100 80GB HBM3")


def test_peaks():
    assert H100 == (3.35e12, 989e12)
    assert yardstick.peaks("NVIDIA H100 PCIe")[1] == 756e12
    with pytest.raises(ValueError):
        yardstick.peaks("NVIDIA A100")


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert yardstick.union_length(iv) == 4
    assert yardstick.idle_gaps(iv, 0, 10) == [(3, 5), (6, 10)]
    assert yardstick.union_length([]) == 0


def test_attention_costs_at_the_flagship_shapes():
    # 12 heads of 64, 129 tokens, 3 modalities: eval [384, 129, 768], train [192, ...]
    ops, nbytes = yardstick.attention_fwd_cost([384, 129, 768], [384, 129, 768])
    assert ops == 4 * 384 * 129 * 129 * 768 and nbytes == 2 * 4 * 384 * 129 * 768
    assert yardstick.least_seconds(ops, nbytes, *H100) == pytest.approx(0.0909e-3, rel=1e-3)
    ops, nbytes = yardstick.attention_bwd_cost([192, 129, 768], [192, 129, 768])
    assert nbytes == 2 * 7 * 192 * 129 * 768
    assert yardstick.least_seconds(ops, nbytes, *H100) == pytest.approx(0.0795e-3, rel=2e-3)


@pytest.mark.parametrize("workload", ["rgbnt201-train", "rgbnt100-train"])
@pytest.mark.parametrize("train", [True, False])
def test_frozen_flops_equal_the_ports(workload, train):
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.models.signal_model import ModelSpec
    from signal_tpu_torch.utils.flops import signal_analytic_flops

    from portbench import harness

    data = spec.load_cell(harness.HERE.parent, workload).config
    arch = spec.reference_arch(data, train=train)
    mspec = ModelSpec.from_config(load_config(None, spec.port_overrides(data)),
                                  arch["num_classes"], arch["camera_num"])
    for batch in (64, 128):
        assert yardstick.signal_flops(arch, batch, train=train) == \
            signal_analytic_flops(mspec, batch, train=train)


def test_kinds_are_the_profile_scripts():
    import importlib.util

    from portbench import harness

    path = harness.HERE.parent / "scripts" / "profile_torch_train.py"
    loader = importlib.util.spec_from_file_location("profile_torch_train", path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    for key, _ in mod.KINDS:
        name = f"void {key}_kernel<float>"
        assert (yardstick.kind_of(name) == "GEMM") == (mod.kind_of(name) == "GEMM")
        assert (yardstick.kind_of(name) in yardstick.MEMORY_PASS_KINDS) == \
            (mod.kind_of(name) in ("elementwise", "copy / cast"))


def _trace():
    """A window of 100 µs from the first CUDA call to the last operation's
    end: an attention forward launch (2 kernels, 20 µs busy), a GEMM (30
    µs) overlapping an elementwise kernel (10 µs), a copy from the host
    (5 µs), and nothing else."""
    fwd = HostOp("signal_tpu_torch::attention_fwd", 0, 30, 1,
                 [[384, 129, 768], [384, 129, 768], [384, 129, 768], []])
    ops = [DeviceOp("fwd_a", 10, 10, "kernel", [fwd]),
           DeviceOp("fwd_b", 20, 10, "kernel", [fwd]),
           DeviceOp("nvjet_gemm", 40, 30, "kernel", []),
           DeviceOp("vectorized_elementwise_kernel", 60, 10, "kernel", []),
           DeviceOp("Memcpy HtoD", 80, 5, "gpu_memcpy", [])]
    ops.append(DeviceOp("vectorized_elementwise_kernel", 95, 5, "kernel", []))
    calls = [HostOp("cudaLaunchKernel", 0, 1, 1), HostOp("cudaStreamSynchronize", 72, 100, 1)]
    return Trace(ops, [fwd], 1, {readers.WINDOW_MARK: (0.0, 100.0)}, calls)


def test_readers_on_a_hand_made_trace():
    t = _trace()
    ctx = readers.Readings(unit_flops=1e12, bw=H100[0], flops=H100[1],
                           trace=t, traced_units=2, timeline=t, host_units=10,
                           host_seconds=1.0, enqueue_s=[0.001, 0.003])
    assert readers.idle_pct(ctx) == pytest.approx(100 * (1 - 60 / 100))
    assert readers.kind_ms(ctx, ("GEMM",)) == pytest.approx(30 / 1e3 / 2)
    assert readers.kind_ms(ctx, yardstick.MEMORY_PASS_KINDS) == pytest.approx(15 / 1e3 / 2)
    least = yardstick.least_seconds(*yardstick.attention_fwd_cost([384, 129, 768],
                                                                  [384, 129, 768]), *H100)
    assert readers.attention_roofline(ctx, "forward") == pytest.approx(100 * least / 20e-6)
    assert readers.attention_roofline(ctx, "backward") is None
    assert readers.mfu(ctx) == pytest.approx(100 * 1e13 / 989e12)
    assert readers.host_enqueue_ms(ctx) == pytest.approx(2.0)


def test_readers_without_a_trace_read_nothing():
    ctx = readers.Readings(unit_flops=1.0, bw=1.0, flops=1.0)
    for read in (readers.idle_pct, readers.mfu, readers.host_enqueue_ms,
                 lambda c: readers.kind_ms(c, ("GEMM",)),
                 lambda c: readers.attention_roofline(c, "forward")):
        assert read(ctx) is None


def test_breakdown_names_what_the_host_was_in_at_each_gap():
    from portbench import harness

    t = _trace()
    t.host_ops = []            # a timeline: CUDA activity alone
    ctx = readers.Readings(unit_flops=1.0, bw=1.0, flops=1.0, timeline=t)
    brk = harness.breakdown(ctx)
    assert brk["device_ops"][0] == ["nvjet_gemm", 30e-6]
    # gaps (0, 10): 1 µs in the launch call, then plain host work;
    # (30, 40) and (70, 80) begin outside any call; (85, 95) in the synchronise
    gaps = dict(brk["idle_gaps"])
    assert math.isclose(gaps["cudaLaunchKernel"], 10e-6)
    assert math.isclose(gaps["host work outside CUDA calls"], 20e-6)
    assert math.isclose(gaps["cudaStreamSynchronize"], 10e-6)

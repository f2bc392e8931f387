"""The tower's one-pass GEMM epilogues (``signal_tpu_torch/ops/epilogue.py``)
on the CPU, where each operator runs its plain chain: each against the
ATen chain the blocks ran before it, the tower's forward with grad mode
off (through the operators) against the grad-mode forward (through the
chain), the cases that keep the chain, and the operators kept in an
exported graph. The kernels themselves are held to the chain on the card
(``tests/test_torch_cuda.py``)."""

import types

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from signal_tpu_torch.models import signal_model as sm
from signal_tpu_torch.models import vit
from signal_tpu_torch.models.vit_prompt import vit_forward_prompt
from signal_tpu_torch.ops import epilogue
from signal_tpu_torch.ops.attention import leave_model, linear, quick_gelu

OPS = ("bias_cast", "bias_gelu", "bias_residual")
TOWER = dict(num_classes=5, camera_num=3, width=128, layers=2, num_heads=4, feat_dim=64,
             h=4, w=2, topk=3)


class _Ops(TorchDispatchMode):
    """Counts the epilogue operators dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.counts = dict.fromkeys(OPS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ns, _, name = func._schema.name.partition("::")
        if ns == "signal_tpu_torch" and name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", OPS)
@pytest.mark.parametrize("rows,cols", [(1, 8), (37, 24), (129, 768), (5, 3072)])
def test_operator_equals_the_aten_chain(name, rows, cols):
    """Each operator's CPU route against what the blocks ran before it, from
    the same product: ``linear``'s fp32 bias add, then the cast of
    ``flash_attention`` (q, k, v), of ``out_dtype`` and QuickGELU (fc), or
    of the branch and the bf16 residual add (out-proj, c_proj); ragged row
    counts, widths 8 to 3072, to the bit."""
    gen = torch.Generator().manual_seed(rows * cols)
    n = 3 if name == "bias_cast" else 1
    h = torch.randn(rows, 16, generator=gen).to(torch.bfloat16)
    ws = [torch.randn(cols, 16, generator=gen) for _ in range(n)]
    bias = torch.randn(n * cols, generator=gen)
    accs = [linear(w, None, h) for w in ws]
    if name == "bias_cast":
        want = [linear(w, b, h).to(torch.bfloat16) for w, b in zip(ws, bias.chunk(3))]
        got = torch.ops.signal_tpu_torch.bias_cast(*accs, bias)
    elif name == "bias_gelu":
        want = [quick_gelu(linear(ws[0], bias, h, out_dtype=torch.bfloat16))]
        got = [torch.ops.signal_tpu_torch.bias_gelu(accs[0], bias)]
    else:
        x = (4 * torch.randn(rows, cols, generator=gen)).to(torch.bfloat16)
        want = [x + leave_model(accs[0], bias).to(x.dtype)]
        got = [torch.ops.signal_tpu_torch.bias_residual(accs[0], bias, x)]
    assert len(got) == n
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == (rows, cols)
        assert torch.equal(g, w)


def _tower(**kw):
    spec = sm.ModelSpec(**{**TOWER, "compute_dtype": "bfloat16", **kw})
    return spec, sm.init_signal(spec, seed=0).clip_vision_encoder.base


def _forward(spec, tower, x, cv, use_flash):
    if spec.prompt:
        return vit_forward_prompt(tower, x, cv, "nir", num_heads=spec.num_heads,
                                  compute_dtype=spec.cdtype, use_flash=use_flash)
    return vit.vit_forward(tower, x, cv, num_heads=spec.num_heads, compute_dtype=spec.cdtype,
                           use_flash=use_flash, moe_topk=spec.moe_topk)


def _images(spec, B=3):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(B, 3, 16 * spec.h, 16 * spec.w, generator=gen)
    return x, 0.02 * torch.randn(B, spec.width, generator=gen)


@pytest.mark.parametrize("case,use_flash", [("plain", True), ("plain", False),
                                            ("prompt", True), ("frozen", True)])
def test_forward_without_grad_equals_grad_mode(case, use_flash):
    """The bf16 tower with grad mode off runs each block's four epilogues
    through the operators (bias_cast only before the attention kernel: the
    eager core scales q in fp32), with grad mode on through the ATen chain:
    the same bits. MODEL.PROMPT's blocks and MODEL.FROZEN's merged LoRA
    kernels take the same path."""
    spec, tower = _tower(prompt=case == "prompt", frozen=case == "frozen")
    x, cv = _images(spec)
    seen = _Ops()
    with torch.no_grad(), seen:
        got = _forward(spec, tower, x, cv, use_flash)
    want = _forward(spec, tower, x, cv, use_flash)
    assert seen.counts == {"bias_cast": spec.layers if use_flash else 0,
                           "bias_gelu": spec.layers, "bias_residual": 2 * spec.layers}
    for g, w in zip(got, want):
        assert w.requires_grad and torch.equal(g, w.detach())


def _mesh(tp):
    return types.SimpleNamespace(model_group=object(), tp=tp, pp=1)


@pytest.mark.parametrize("case", ["adapter", "moe", "fp32", "grad", "tensor", "sequence"])
def test_bypass_keeps_the_aten_chain(case):
    """Where the operators do not apply, a block keeps the ATen chain:
    MODEL.ADAPTER and MoE blocks (terms added before the cast), fp32, grad
    mode on (the operators have no backward), tensor and sequence
    parallelism (the biases follow a collective; told by the block's mesh
    and the tower's token count, the forward itself needs a world)."""
    kw = dict(adapter=case == "adapter", moe_experts=4 if case == "moe" else 0,
              compute_dtype="float32" if case == "fp32" else "bfloat16")
    spec, tower = _tower(**kw)
    x, cv = _images(spec)
    blk = tower.transformer.resblocks[0]
    stream = torch.zeros(2, 9, spec.width, dtype=spec.cdtype)
    if case in ("tensor", "sequence"):
        seq = 9 if case == "sequence" else None
        blk.mesh = _mesh(2)
        with torch.no_grad():
            assert not vit._one_pass_epilogues(blk, stream, spec.cdtype, seq)
            blk.mesh = _mesh(1)
            assert vit._one_pass_epilogues(blk, stream, spec.cdtype, None)
        return
    seen = _Ops()
    with torch.set_grad_enabled(case == "grad"), seen:
        assert not vit._one_pass_epilogues(blk, stream, spec.cdtype, None)
        _forward(spec, tower, x, cv, True)
    assert seen.counts == dict.fromkeys(OPS, 0)


def test_exported_graph_keeps_the_operators(tmp_path):
    """A bf16 tower exported with grad mode off holds each block's four
    operators (their fake implementations trace it) beside the attention
    operator, and the saved and loaded program gives the eager bits."""
    spec, tower = _tower()

    class Tower(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.tower = tower

        def forward(self, x, cv):
            return _forward(spec, self.tower, x, cv, True)

    x, cv = _images(spec, B=2)
    with torch.no_grad():
        ep = torch.export.export(Tower(), (x, cv), strict=False)
        want = _forward(spec, tower, x, cv, True)
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    L = spec.layers
    assert [ops.count(f"signal_tpu_torch.{name}.default")
            for name in ("attention_fwd", *OPS)] == [L, L, L, 2 * L]
    torch.export.save(ep, str(tmp_path / "tower.pt2"))
    with torch.no_grad():
        got = torch.export.load(str(tmp_path / "tower.pt2")).module()(x, cv)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_launchers_refuse_cpu_tensors():
    """The launchers take CUDA tensors only: a CPU tensor goes through the
    operator's plain route, never to them."""
    acc, bias = torch.zeros(4, 8), torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        epilogue.bias_gelu_cuda(acc, bias)
    with pytest.raises(ValueError, match="CUDA"):
        epilogue.bias_cast_cuda(acc, acc, acc, torch.zeros(24))
    with pytest.raises(ValueError, match="CUDA"):
        epilogue.bias_residual_cuda(acc, bias, acc.to(torch.bfloat16))

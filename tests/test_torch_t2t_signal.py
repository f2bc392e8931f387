"""Signal on the T2T-ViT tower against the benchmark's plain reference
(``portbench/reference/t2t.py``) on the CPU at a toy size, the token
attention operator against the expression it replaced, and the tracing
it adds.

The toy: the T2T cell's configuration file with a tower 96 wide, 2 blocks
of 4 heads, on 64×64 images (16×16 → 8×8 → 4×4 tokens, the 4×4 grid the
least LAM's offsets take), SIM TOPK 3, weights drawn as the cell draws
them. Each tolerance says what it separates.
"""

import json
from pathlib import Path

import pytest
import torch

from portbench import harness, spec
from portbench.kinds.t2t_gallery import make_weights
from portbench.reference import model as ref_model
from portbench.reference import recipe
from portbench.reference import t2t as ref_t2t
from signal_tpu_torch.losses import make_loss, total_train_loss
from signal_tpu_torch.models import signal_model as sm
from signal_tpu_torch.models import t2t as tt2t
from signal_tpu_torch.ops import token_attention as ta
from signal_tpu_torch.ops.token_attention import eager_core, token_attention, token_attention_cuda
from signal_tpu_torch.utils import flops
from signal_tpu_torch.utils.profiler import recording

ROOT = Path(__file__).resolve().parent.parent
B = 4

# float32 port against the float32 reference: the same function summed in
# another order. Sound runs read ~1e-6; a body run in bf16 reads ~1e-2.
FP32_FEATURES = 1e-4
FP32_LOSS = 1e-5
FP32_GRAD = 1e-3
# the configured bf16 body against the float32 reference: a few bf16
# roundings (2^-9 each) through 2 blocks and SIM read ~5e-3; the float8
# control (3 bits of mantissa) reads several times this
BF16_FEATURES = 2e-2
# the token transformers run in float32 whatever the compute dtype: against
# the reference's at rounding; one run in bf16 reads ~1e-2
TOKEN_TRANSFORMER = 1e-5


def _toy(compute_dtype: str):
    cfg = json.loads((ROOT / "portbench/configs/rgbnt201-t2t14-signal.json").read_text())
    cfg["architecture"].update(width=96, layers=2, heads=4, feat_dim=96)
    cfg["published"]["INPUT"].update(SIZE_TRAIN=[64, 64], SIZE_TEST=[64, 64])
    cfg["published"]["MODEL"]["TOPK"] = 3
    cfg["assumed"].update(num_classes=8, camera_num=2)
    cfg["port"]["MODEL"].update(DEVICE="cpu", COMPUTE_DTYPE=compute_dtype)
    cell = spec.Cell(name="toy", chips=1, config=cfg, traffic={}, per_layer=[], end_to_end=[])
    run = harness.Run(cell=cell, seed=2 ** 31 + 5, seconds=0.0, trace=False,
                      device=torch.device("cpu"), t_start=0.0)
    arch = ref_t2t.reference_arch(cfg, train=False)
    weights = make_weights(arch, run.seed, run.device)
    port_cfg, model = harness.build_port(run, weights)
    return cfg, arch, weights, port_cfg, model


def _batch(arch, seed=3):
    g = torch.Generator().manual_seed(seed)
    u8 = torch.randint(0, 256, (B, 3, 3, arch["img_h"], arch["img_w"]), dtype=torch.uint8,
                       generator=g)
    return u8, torch.tensor([0, 1, 1, 0]), torch.tensor([0, 0, 1, 1])


def _row_gap(a, b) -> float:
    return float((torch.linalg.vector_norm(a - b, dim=1) /
                  torch.linalg.vector_norm(b, dim=1)).max())


@pytest.mark.parametrize("dtype,limit", [("float32", FP32_FEATURES),
                                         ("bfloat16", BF16_FEATURES)])
def test_features_match_the_reference(dtype, limit):
    cfg, arch, weights, port_cfg, model = _toy(dtype)
    hp = spec.recipe(cfg)
    u8, cams, _ = _batch(arch)
    with torch.inference_mode():
        got = sm.forward_eval(model, recipe.normalize(u8, hp["mean"], hp["std"]), cams)
    want = ref_t2t.gallery_features(weights, arch, hp, u8, cams)
    assert got.shape == want.shape == (B, 6 * 96)
    gap = _row_gap(got, want)
    assert gap <= limit, gap
    if dtype == "bfloat16":
        # the bf16 body is not float32 in disguise
        assert gap > FP32_FEATURES, gap
        control = ref_t2t.gallery_features(weights, arch, hp, u8, cams, precision="fp8")
        assert _row_gap(control, want) > limit


def test_token_transformers_stay_float32_in_a_bf16_model():
    _, arch, weights, _, model = _toy("bfloat16")
    x = torch.randn(2, 256, 147, generator=torch.Generator().manual_seed(4))
    got = tt2t.token_transformer(model.base.tokens_to_token.attention1, x)
    want = ref_t2t.token_transformer(weights, ref_t2t.T2T + "attention1", x)
    torch.testing.assert_close(got, want, rtol=TOKEN_TRANSFORMER, atol=TOKEN_TRANSFORMER)


def test_token_map_is_the_references():
    """The map the benchmark's ``t2t_gap`` compares: both token transformers
    and soft splits, float32 in a bf16 model, as the reference's."""
    cfg, arch, weights, _, model = _toy("bfloat16")
    hp = spec.recipe(cfg)
    u8, _, _ = _batch(arch)
    with torch.no_grad():
        got = tt2t.token_map(model.base.tokens_to_token,
                             recipe.normalize(u8, hp["mean"], hp["std"]).flatten(0, 1))
    assert got.dtype == torch.float32 and got.shape == (3 * B, 64, 8, 8)
    want = ref_t2t.gallery_token_maps(weights, arch, hp, u8)
    torch.testing.assert_close(got.flatten(1), want, rtol=TOKEN_TRANSFORMER,
                               atol=TOKEN_TRANSFORMER)


def test_train_loss_and_tower_gradients_match_the_reference():
    cfg, arch, weights, port_cfg, model = _toy("float32")
    hp = spec.recipe(cfg)
    u8, cams, pids = _batch(arch, seed=6)
    x = recipe.normalize(u8, hp["mean"], hp["std"])
    model.train()
    out = sm.forward_train(model, x, cams)
    loss = total_train_loss(out, pids, make_loss(port_cfg, arch["num_classes"]),
                            gram_weight=port_cfg.MODEL.Gram_Loss_weight,
                            pat_weight=port_cfg.MODEL.PAT_Loss_weight)
    loss.backward()
    tower = [n for n, _ in ref_t2t.param_shapes(arch) if n.startswith(ref_t2t.TOWER)]
    P = {n: t.detach().clone().requires_grad_(n in tower) for n, t in weights.items()}
    want = ref_t2t.train_loss(ref_model.Arith("fp32"), P, arch, hp, x, pids, cams)
    grads = torch.autograd.grad(want, [P[n] for n in tower])
    assert loss.item() == pytest.approx(want.item(), rel=FP32_LOSS)
    params = dict(model.named_parameters())
    worst = max(float(torch.linalg.vector_norm(params[n].grad - g) /
                      torch.linalg.vector_norm(g)) for n, g in zip(tower, grads))
    assert worst <= FP32_GRAD, worst


def _eager(q, k, v, scale):
    """The expression the operator replaced, as ``token_transformer`` had it."""
    return torch.softmax((q * scale) @ k.transpose(1, 2), dim=-1) @ v


def test_token_attention_is_the_eager_expression():
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(3, 40, 64, generator=g, requires_grad=True) for _ in range(3))
    out = token_attention(q, k, v, 147 ** -0.5)
    want = _eager(q, k, v, 147 ** -0.5)
    assert torch.equal(out, want)          # the same operations: the same bits
    dout = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, (q, k, v), dout)
    exp = torch.autograd.grad(want, (q, k, v), dout)
    for a, b in zip(got, exp):
        # the same softmax backward; the products' layouts may differ from
        # autograd's (dKᵀ against dK): fp32 rounding of 40-term sums
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_token_attention_gradcheck_in_float64():
    g = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn(2, 6, 4, generator=g, dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    assert torch.autograd.gradcheck(lambda a, b, c: token_attention(a, b, c, 0.7), (q, k, v))


def _token_views(B, L, width=192, dtype=torch.float32):
    """q, k, v as ``token_transformer`` gives them: the ``.chunk(3, -1)``
    views of a [B, L, width] qkv product (row stride ``width``)."""
    g = torch.Generator().manual_seed(9)
    return torch.randn(B, L, width, generator=g).to(dtype).chunk(3, dim=-1)


@pytest.mark.parametrize("case", ["float32", "head_dim_32", "float64", "bfloat16"])
def test_token_attention_takes_the_eager_core_off_the_card(case):
    """Off the card every input takes the eager core, bit for bit, and no
    kernel launch is counted: fp32 at head dim 64 as T2T gives it, another
    head dim, float64 and bf16. The card's route takes only the first and
    raises on the others, before any launch."""
    width = 96 if case == "head_dim_32" else 192
    dtype = {"float64": torch.float64, "bfloat16": torch.bfloat16}.get(case, torch.float32)
    q, k, v = _token_views(2, 24, width, dtype)
    launches = token_attention_cuda.launches
    out = token_attention(q, k, v, 147 ** -0.5)
    assert torch.equal(out, eager_core(q, k, v, 147 ** -0.5))
    assert token_attention_cuda.launches == launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        token_attention_cuda(q, k, v, 147 ** -0.5)
    if case == "float32":
        assert all(a is b for a, b in zip(ta._operands(q, k, v), (q, k, v)))
    else:
        with pytest.raises(ValueError, match="fp32 q"):
            ta._operands(q, k, v)


def test_the_kernel_takes_what_tma_can_address():
    """The kernel reads the qkv product's chunk views and contiguous
    tensors as they lie; a row stride or base off a 16-byte multiple, a
    batch stride that overlaps rows or a last stride other than 1 is read
    from a contiguous copy of the same values; k and v of different
    lengths, or an empty length, raise."""
    q, k, v = _token_views(2, 24)
    # the views, a contiguous tensor, a row stride of 528 B with its base 16 B in
    for t in (q, k.contiguous(), torch.randn(2, 24, 132)[..., 4:68]):
        assert ta._operands(t, k, v)[0] is t
    misfits = [torch.randn(2, 24, 66)[..., :64],   # row stride 264 B
               torch.randn(2, 24, 68)[..., 1:65],   # base 4 B in
               torch.randn(1, 24, 64).expand(2, 24, 64),   # batch stride 0
               v.transpose(1, 2).contiguous().transpose(1, 2)]   # last stride 24
    for t in misfits:
        for i in range(3):
            args = [q, k, v]
            args[i] = t
            got = ta._operands(*args)
            assert got[i] is not t and got[i].is_contiguous() and torch.equal(got[i], t)
            assert got[i].data_ptr() % 16 == 0
            assert all(got[j] is args[j] for j in range(3) if j != i)
    for bad in ((q, k[:, :10], v), (q[:, :0], k, v), (q, k[:, :0], v[:, :0])):
        with pytest.raises(ValueError, match="fp32 q"):
            ta._operands(*bad)


def test_t2t_span_and_call_counter():
    cfg, arch, _, _, model = _toy("bfloat16")
    hp = spec.recipe(cfg)
    u8, cams, _ = _batch(arch)
    x = recipe.normalize(u8, hp["mean"], hp["std"])
    before = token_attention.calls
    with recording() as spans, torch.inference_mode():
        sm.forward_eval(model, x, cams)
    assert token_attention.calls - before == 2          # one a token transformer
    names = [s.name for s in spans]
    assert names.count("model.t2t") == 1
    t2t_span = spans[names.index("model.t2t")]
    assert t2t_span.parent.name == "model.tower"
    assert t2t_span.start_ns >= t2t_span.parent.start_ns and \
        t2t_span.end_ns <= t2t_span.parent.end_ns


def test_model_flops_add_the_token_attention_the_counter_cannot_see():
    _, arch, _, _, model = _toy("float32")
    spec_ = model.spec
    x = torch.zeros(1, 3, 3, arch["img_h"], arch["img_w"])
    with torch.inference_mode():
        counted = flops.cost_analysis(sm.forward_eval, model, x, torch.zeros(1, dtype=torch.long))
    token = flops.token_attention_flops(spec_, 1)
    # QKᵀ and A·V of one head of 64 at 16×16 and 8×8 tokens, for 3 images
    assert token == 3 * 4.0 * 64 * (256 ** 2 + 64 ** 2)
    assert spec_.attention_kernel
    assert flops.model_flops(model, 1) == pytest.approx(
        counted["flops"] + flops.flash_attention_flops(spec_, 1) + token, rel=1e-12)
    assert flops.token_attention_flops(sm.ModelSpec(num_classes=2, camera_num=2), 1) == 0.0


def test_a_tower_built_on_a_device_holds_its_table_there():
    """Built under ``torch.device(...)`` (as the benchmark builds the
    model on the card), every tensor of the tower is on that device, the
    fixed sinusoid table too."""
    with torch.device("meta"):
        net = tt2t.T2TViT(img_size=(64, 32), embed_dim=96, depth=1, camera_num=2)
    assert {t.device.type for t in net.state_dict().values()} == {"meta"}
    torch.testing.assert_close(tt2t.T2TViT(img_size=(64, 32), embed_dim=96, depth=1).pos_embed[0],
                               ref_t2t.sinusoid_table(9, 96), rtol=0, atol=1e-6)

"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker
and skip on hosts without a card. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

# the bf16 kernels pad rows and the head dim to multiples of 16: every
# length at or next to a tile edge, at head dims 8 and 24 (a zero-padded
# contraction), 64 and 128; cross attention both ways
_EDGE_LENGTHS = [(n, n) for n in (1, 15, 16, 17, 129, 145)] + [
    (1, 145), (145, 1), (17, 129), (129, 16), (15, 17)]
_EDGES = [(2, lq, lk, 2 * hd, 2, torch.bfloat16)
          for hd in (8, 24, 64, 128) for lq, lk in _EDGE_LENGTHS]
# past 160 tokens the bf16 backward takes its long route: lengths across
# its 64-row tiles, STRIDE_SIZE 12's 211 and a 384×128 input's 193, and
# cross attention both ways
_LONG_EDGES = [(2, lq, lk, 2 * hd, 2, torch.bfloat16) for hd in (64, 128)
               for lq, lk in [(n, n) for n in (161, 176, 193, 211, 223, 256)]
               + [(211, 129), (129, 211)]]
# the long route's own edges: one past a ring chunk of 32 queries (193,
# 225), one past a block's keys, where the cluster grows by a block (256
# keys a block at hd 64: 257, 513, 769; 128 at hd 128: 385, 641, 897 too),
# its longest (1024 keys), and a single key or query against many
_LONG_TILE_EDGES = [(2, lq, lk, 2 * hd, 2, torch.bfloat16) for hd in (64, 128)
                    for lq, lk in [(n, n) for n in (225, 257, 385, 513, 641, 769, 897, 1024)]
                    + [(257, 1), (1, 257), (1024, 17), (17, 1024)]]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is compiled with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,Lq,Lk,D,H,dtype", [
    (8, 129, 129, 768, 12, torch.bfloat16),   # the ViT-B blocks' shape
    (8, 129, 129, 768, 12, torch.float32),
    (4, 3, 384, 512, 8, torch.float32),       # cross attention, Lq != Lk
    (4, 9, 9, 384, 6, torch.bfloat16),        # odd: 6 heads of 64
    (8, 129, 129, 384, 6, torch.bfloat16),    # deit_small's blocks: D 384, 6 heads
    (8, 129, 129, 384, 6, torch.float32),
    (128, 129, 129, 768, 12, torch.bfloat16),  # CLIP-ReID's eval: one modality, B 128
    (128, 129, 129, 768, 12, torch.float32),
    (64, 129, 129, 768, 12, torch.bfloat16),  # and its train step, B 64
    (64, 129, 129, 768, 12, torch.float32),
    (2, 17, 33, 256, 2, torch.float32),       # hd 128, ragged lengths
    (4, 3, 384, 512, 8, torch.bfloat16),      # keys past a register row: two passes
    (2, 17, 300, 256, 2, torch.bfloat16),     # the same at hd 128
    *_EDGES,
])
def test_attention_kernel_matches_plain_version(cuda_device, B, Lq, Lk, D, H, dtype):
    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda, flash_attention_reference

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(B, Lq, D, device=cuda_device, generator=gen).to(dtype)
    k = torch.randn(B, Lk, D, device=cuda_device, generator=gen).to(dtype)
    v = torch.randn(B, Lk, D, device=cuda_device, generator=gen).to(dtype)
    before = attention_fwd_cuda.launches
    got = attention_fwd_cuda(q, k, v, H)
    torch.cuda.synchronize()
    assert attention_fwd_cuda.launches == before + 1
    want = flash_attention_reference(q, k, v, H)
    # fp32: summation order only; bf16: one bf16 ulp of |o| < 4
    tol = dict(atol=2e-5, rtol=1e-4) if dtype == torch.float32 else dict(atol=1.6e-2, rtol=0)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


def test_attention_kernel_rejects_what_it_cannot_take(cuda_device):
    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda

    q = torch.zeros(1, 4, 12 * 4, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        attention_fwd_cuda(q, q, q, 12)                   # hd = 4
    q = torch.zeros(1, 4, 256, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        attention_fwd_cuda(q, q, q, 4)
    q = torch.zeros(1, 4, 64, device=cuda_device)
    kv = torch.zeros(1, 4000, 64, device=cuda_device)
    with pytest.raises(ValueError, match="shared"):
        attention_fwd_cuda(q, kv, kv, 1)                  # Lk beyond shared memory


def test_attention_fwd_kernel_refuses_a_graph(cuda_device):
    """The forward kernel's output has no grad_fn: called directly under
    grad mode with an input that requires grad, the wrapper raises."""
    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda

    q = torch.zeros(2, 9, 128, device=cuda_device, requires_grad=True)
    kv = torch.zeros(2, 9, 128, device=cuda_device)
    with pytest.raises(RuntimeError, match="grad_fn"):
        attention_fwd_cuda(q, kv, kv, 2)
    with torch.no_grad():
        attention_fwd_cuda(q, kv, kv, 2)


@pytest.mark.parametrize("B,Lq,Lk,D,H,dtype", [
    (8, 129, 129, 768, 12, torch.bfloat16),   # the ViT-B blocks' shape
    (8, 129, 129, 768, 12, torch.float32),
    (4, 3, 129, 512, 8, torch.float32),       # cross attention, Lq < Lk
    (4, 40, 7, 512, 8, torch.bfloat16),       # cross attention, Lq > Lk
    (4, 9, 9, 384, 6, torch.bfloat16),        # odd: 6 heads of 64
    (8, 129, 129, 384, 6, torch.bfloat16),    # deit_small's blocks: D 384, 6 heads
    (8, 129, 129, 384, 6, torch.float32),
    (64, 129, 129, 768, 12, torch.bfloat16),  # CLIP-ReID's train step: one modality, B 64
    (64, 129, 129, 768, 12, torch.float32),
    (2, 17, 33, 256, 2, torch.float32),       # hd 128, ragged lengths
    (2, 160, 160, 256, 2, torch.bfloat16),    # the longest the fused bf16 kernel takes
    (4, 211, 211, 768, 12, torch.bfloat16),   # STRIDE_SIZE 12: the long route
    (2, 640, 640, 128, 2, torch.bfloat16),    # the first long route's longest at hd 64
    (2, 288, 288, 256, 2, torch.bfloat16),    # and at hd 128
    *_EDGES,
    *_LONG_EDGES,
    *_LONG_TILE_EDGES,
])
def test_attention_bwd_kernel_matches_plain_version(cuda_device, B, Lq, Lk, D, H, dtype):
    from signal_tpu_torch.ops.flash_attention import (
        attention_bwd_cuda,
        flash_attention_bwd_reference,
    )

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, g = (torch.randn(B, Lq, D, device=cuda_device, generator=gen).to(dtype) for _ in "qg")
    k, v = (torch.randn(B, Lk, D, device=cuda_device, generator=gen).to(dtype) for _ in "kv")
    before = attention_bwd_cuda.launches
    got = attention_bwd_cuda(q, k, v, g, H)
    torch.cuda.synchronize()
    assert attention_bwd_cuda.launches == before + 1
    want = flash_attention_bwd_reference(q, k, v, g, H)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
        if dtype == torch.float32:
            # summation order only
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=name)
        else:
            # dS is rounded to bf16 before dQ/dK: a different fp32 order of
            # dP·P can tip an element across a bf16 rounding boundary, and
            # the outputs are bf16. On randn inputs the gradients are ~0.15
            # and peak at 2-3: two ulps of |x| < 1 (2 · 2^-8) absolute, and
            # rtol 1e-2 (one ulp is 2^-8 to 2^-7 of the value) above
            np.testing.assert_allclose(a, b, atol=8e-3, rtol=1e-2, err_msg=name)


def test_attention_bwd_kernel_rejects_what_it_cannot_take(cuda_device):
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda

    before = attention_bwd_cuda.launches
    q = torch.zeros(1, 4, 64, device=cuda_device)
    kv = torch.zeros(1, 1000, 64, device=cuda_device)
    with pytest.raises(ValueError, match="shared"):
        attention_bwd_cuda(q, kv, kv, q, 1)               # Lk beyond shared memory
    for Lk, hd in ((1040, 64), (1040, 128)):
        # past the long route's bound: 1024 keys (a cluster of 8 blocks of
        # 128 keys) at any head dim
        qh = torch.zeros(1, 4, hd, device=cuda_device, dtype=torch.bfloat16)
        kv = torch.zeros(1, Lk, hd, device=cuda_device, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="at most 1024 keys"):
            attention_bwd_cuda(qh, kv, kv, qh, 1)
    assert attention_bwd_cuda.launches == before


def test_attention_bwd_long_route_repeats_to_the_bit(cuda_device):
    """The long route sums dQ over a head's key blocks in a fixed order
    (rank order through distributed shared memory, no atomics): two
    launches on the same inputs give the same bits."""
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, g = (torch.randn(4, 211, 768, device=cuda_device, generator=gen).bfloat16()
                  for _ in "qkvg")
    before = attention_bwd_cuda.launches_long
    first = attention_bwd_cuda(q, k, v, g, 12)
    second = attention_bwd_cuda(q, k, v, g, 12)
    torch.cuda.synchronize()
    assert attention_bwd_cuda.launches_long == before + 2
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_bf16_kernels_run_on_the_tensor_cores_without_spills(cuda_device):
    """Each library's bf16 kernels hold tensor-core instructions (HMMA in
    ``cuobjdump -sass``) and spill nothing (``nvcc -Xptxas -v``)."""
    from signal_tpu_torch.ops import _build

    try:
        _build.cuda_tool("cuobjdump")
    except RuntimeError:
        pytest.skip("needs cuobjdump")
    for name in ("attention_fwd", "attention_bwd"):
        hmma = {fn: n for fn, n in _build.hmma_counts(name).items() if "mma_kernel" in fn}
        assert hmma and all(hmma.values()), (name, hmma)
        report = {fn: r for fn, r in _build.ptxas_report(name).items() if "mma_kernel" in fn}
        assert report.keys() == hmma.keys(), (name, report, hmma)
        for fn, r in report.items():
            assert r["spill_stores"] == r["spill_loads"] == 0, (fn, r)


def test_flash_attention_gradients_go_through_both_kernels(cuda_device):
    from signal_tpu_torch.ops.flash_attention import (
        attention_bwd_cuda,
        attention_fwd_cuda,
        flash_attention,
    )

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn(4, 129, 256, device=cuda_device, generator=gen, requires_grad=True)
               for _ in "qkv")
    fwd, bwd = attention_fwd_cuda.launches, attention_bwd_cuda.launches
    out = flash_attention(q, k, v, num_heads=4, compute_dtype=torch.float32)
    grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    assert attention_fwd_cuda.launches == fwd + 1 and attention_bwd_cuda.launches == bwd + 1
    from signal_tpu_torch.ops.attention import _attention_core

    want = torch.autograd.grad((_attention_core(q, k, v, 4, torch.float32) ** 2).sum(),
                               (q, k, v))
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=5e-4, rtol=1e-3)


def test_linear_backward_runs_on_the_card(cuda_device):
    """The bf16 product has a backward on the card (``aten::mm.dtype`` has
    none): gradients with respect to x and the weight, against the fp32
    product's."""
    from signal_tpu_torch.ops.attention import linear

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    w = torch.randn(96, 64, device=cuda_device, generator=gen, requires_grad=True)
    x = torch.randn(5, 7, 64, device=cuda_device, generator=gen, requires_grad=True)
    y = linear(w, None, x, torch.bfloat16)
    assert y.dtype == torch.float32
    gx, gw = torch.autograd.grad(y.square().sum(), (x, w))
    fx, fw = torch.autograd.grad(linear(w, None, x, torch.float32).square().sum(), (x, w))
    for a, b in ((gx, fx), (gw, fw)):
        cos = torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0)
        assert cos > 0.999, cos


@pytest.mark.parametrize("dtype,tol", [(torch.float32, dict(atol=1e-5, rtol=1e-5)),
                                       (torch.bfloat16, dict(atol=1e-2, rtol=0))])
def test_masked_core_on_the_card_equals_the_cpu(cuda_device, dtype, tol):
    """CLIP's causal text attention (the eager core with an additive mask)
    on the card against the CPU, at the text tower's shape (77 tokens, 8
    heads of 64); ``mha`` with ``use_flash`` and a mask launches no kernel.
    fp32: summation order; bf16: one rounding of P apart."""
    from signal_tpu_torch.models.text_encoder import causal_mask
    from signal_tpu_torch.ops.attention import MultiheadAttentionParams, _attention_core, mha, \
        true_fp32
    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda

    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(16, 77, 512, generator=gen) for _ in range(3))
    want = _attention_core(q, k, v, 8, dtype, mask=causal_mask(77))
    with true_fp32():
        got = _attention_core(*(t.to(cuda_device) for t in (q, k, v)), 8, dtype,
                              mask=causal_mask(77, device=cuda_device))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **tol)
    attn = MultiheadAttentionParams(512)
    attn.reset_parameters(gen)
    before = attention_fwd_cuda.launches
    with torch.no_grad():
        out = mha(attn.to(cuda_device), q.to(cuda_device), num_heads=8, compute_dtype=dtype,
                  use_flash=True, mask=causal_mask(77, device=cuda_device))
    torch.cuda.synchronize()
    assert attention_fwd_cuda.launches == before and bool(torch.isfinite(out).all())


def _integer_features(seed, n, dim):
    """Small integers: every distance is exact in fp32 on the card and on
    the CPU, so both rank the same (ties by index) and only summation
    order separates their re-ranked distances."""
    return np.random.default_rng(seed).integers(-3, 4, (n, dim)).astype(np.float32)


def test_reranking_on_the_card_equals_the_cpu(cuda_device):
    from signal_tpu_torch.reranking import re_ranking

    feats = torch.from_numpy(_integer_features(4, 320, 64))       # 40 query + 280 gallery
    want = re_ranking(feats[:40], feats[40:], k1=20, k2=6, lambda_value=0.3)
    got = re_ranking(feats[:40].to(cuda_device), feats[40:].to(cuda_device), k1=20, k2=6,
                     lambda_value=0.3)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5, rtol=1e-4)


def test_accumulation_on_the_card_equals_one_step_on_half(cuda_device):
    """ACCUM_ITER = 2 on [h; h] equals ACCUM_ITER = 1 on h (fp32, SGD,
    center loss, both kernels): each microbatch is h. Each microbatch
    launches the forward kernel twice per block (remat) and the backward
    once."""
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.engine.train import init_centers, make_train_step
    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda
    from signal_tpu_torch.solver import make_optimizer, schedule_coeffs, set_lr

    spec = sm.ModelSpec(num_classes=5, camera_num=3, width=128, layers=2, num_heads=4,
                        feat_dim=64, h=4, w=4, topk=3, compute_dtype="float32", use_flash=True)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randint(0, 256, (8, 3, 3, 64, 64), dtype=torch.uint8, device=cuda_device,
                      generator=gen)
    pids = torch.tensor([0, 0, 3, 3, 1, 1, 4, 4], device=cuda_device)
    cams = torch.randint(0, 3, (8,), device=cuda_device, generator=gen)
    results = []
    dup = tuple(torch.cat([t, t]) for t in (x, pids, cams))
    for accum, batch in ((1, (x, pids, cams)), (2, dup)):
        cfg = load_config("configs/synthetic/smoke.yml", [
            "SOLVER.OPTIMIZER_NAME", "SGD", "SOLVER.ACCUM_ITER", str(accum),
            "MODEL.METRIC_LOSS_TYPE", "triplet_center", "DATALOADER.NUM_INSTANCE", "2",
            "INPUT.SIZE_TRAIN", "[64, 64]", "MODEL.TOPK", "3"])
        model = sm.init_signal(spec, seed=0).to(cuda_device)
        optimizer = make_optimizer(model, cfg)
        set_lr(optimizer, *schedule_coeffs(cfg, 1))
        centers = init_centers(cfg, spec, 5, cuda_device)
        step = make_train_step(model, cfg, 5, optimizer, centers=centers)
        fwd, bwd = attention_fwd_cuda.launches, attention_bwd_cuda.launches
        loss, _ = step(*batch)
        torch.cuda.synchronize()
        assert (attention_fwd_cuda.launches - fwd, attention_bwd_cuda.launches - bwd) == \
            (2 * spec.layers * accum, spec.layers * accum)
        results.append((loss.item(), dict(model.named_parameters()), centers))
    (l1, p1, c1), (l2, p2, c2) = results
    assert l2 == pytest.approx(l1, rel=1e-5)
    for name, p in p1.items():
        torch.testing.assert_close(p2[name], p, rtol=1e-4, atol=1e-6, msg=name)
    torch.testing.assert_close(c2, c1, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name,opts", [
    ("prompt", dict(prompt=True, adapter=True)),
    ("moe", dict(moe_experts=4, moe_topk=2)),
    ("frozen", dict(frozen=True)),
    ("stride12", dict(h=21, w=10, stride_size=12)),
    ("imagenet", dict(backbone="imagenet", feat_dim=128, img_h=64, img_w=64)),
    ("imagenet_stride12", dict(backbone="imagenet", feat_dim=128, h=21, w=10,
                               stride_size=12, img_h=256, img_w=124)),
])
def test_variant_train_step_goes_through_both_kernels(cuda_device, name, opts):
    """One fp32 train step's loss and gradients of a small variant tower on
    the card, kernel path against plain-attention path, with its launches:
    2 forward and 1 backward per block and stream (the prompted tower runs
    three streams; STRIDE_SIZE 12 runs 211 tokens, the backward's long route
    in bf16 — here fp32), and the ImageNet ViT's at both strides."""
    import dataclasses

    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.ops.attention import true_fp32
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda

    spec = sm.ModelSpec(**{**dict(num_classes=5, camera_num=3, width=128, layers=2,
                                  num_heads=2, feat_dim=64, h=4, w=4, topk=3,
                                  compute_dtype="float32"), **opts})
    H = (spec.h - 1) * spec.stride_size + 16
    W = (spec.w - 1) * spec.stride_size + 16
    model = sm.init_signal(spec, seed=0).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(4, 3, 3, H, W, device=cuda_device, generator=gen)
    cams = torch.tensor([0, 1, 2, 0], device=cuda_device)
    params = [p for p in model.parameters() if p.requires_grad]
    runs = []
    for use_flash in (True, False):
        model.spec = dataclasses.replace(spec, use_flash=use_flash)
        fwd, bwd = attention_fwd_cuda.launches, attention_bwd_cuda.launches
        with true_fp32():
            out = sm.forward_train(model, x, cams)
            loss = sum(s.logsumexp(-1).mean() for s in out["scores"]) + out["gam"] + out["lam"]
            if out["moe_aux"] is not None:
                loss = loss + out["moe_aux"]
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        n = (3 if spec.prompt else 1) * spec.layers
        launched = (attention_fwd_cuda.launches - fwd, attention_bwd_cuda.launches - bwd)
        assert launched == ((2 * n, n) if use_flash else (0, 0)), (name, launched)
        runs.append((loss.item(), grads))
    (loss_k, g_k), (loss_p, g_p) = runs
    assert loss_k == pytest.approx(loss_p, rel=1e-5)
    for a, b in zip(g_k, g_p):
        if b is not None and b.norm() > 1e-6:
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4 * b.abs().max().item())

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
    (2, 17, 33, 256, 2, torch.float32),       # hd 128, ragged lengths
    (2, 160, 160, 256, 2, torch.bfloat16),    # the longest the bf16 kernel takes
    *_EDGES,
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
    q, kv = q.bfloat16(), torch.zeros(1, 161, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="160"):
        attention_bwd_cuda(q, kv, kv, q, 1)               # Lk past the register row
    assert attention_bwd_cuda.launches == before


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

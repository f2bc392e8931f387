"""Port parity: gradients of the attention primitives.

* ``flash_attention_bwd_reference`` (the backward kernel's plain version)
  against the JAX package's ``_fused_attention_bwd_impl``, which runs the
  Pallas backward kernel in interpret mode on the CPU;
* the port's ``flash_attention`` gradients (the registered operator's
  autograd formula on CPU tensors) against ``jax.grad`` of the JAX ``flash_attention``, following
  `tests/test_flash_attention.py:46-79`;
* ``linear``'s gradients (the bf16 product's VJP) against ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu.ops import attention as jatt
from signal_tpu.ops.flash_attention import _fused_attention_bwd_impl
from signal_tpu.ops.flash_attention import flash_attention as jax_flash
from signal_tpu_torch.ops import attention as tatt
from signal_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd_reference

from _torch_parity import to_np

# fp32: both sides run true-fp32 dots on the same values; only the
# summation order differs
FP32_TOL = dict(atol=2e-5, rtol=1e-4)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("B,Lq,Lk,D,H", [
    (2, 9, 9, 128, 4),      # self-attention, hd 32
    (2, 3, 17, 128, 4),     # cross attention, Lq != Lk
    (2, 9, 9, 384, 6),      # odd: 6 heads of 64
    # the tile edges of the bf16 kernel: one query row against 17 keys, the
    # ViT's 129 at one head of 64, head dims 8 and 24 (padded to 16, 32)
    (2, 1, 17, 64, 1),
    (1, 129, 129, 64, 1),
    (2, 9, 9, 16, 2),
    (2, 9, 9, 48, 2),
    # past 160 tokens, where the bf16 kernel takes its long route:
    # STRIDE_SIZE 12's 211, and cross attention both ways
    (1, 211, 211, 64, 1),
    (1, 211, 129, 64, 1),
    (1, 129, 211, 64, 1),
], ids=["self", "cross", "odd", "lq1-lk17", "l129", "hd8", "hd24", "l211", "lq211-lk129",
        "lq129-lk211"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_version_matches_jax_kernel(B, Lq, Lk, D, H, dtype):
    q, k, v, g = _arrays(B * Lq + D, (B, Lq, D), (B, Lk, D), (B, Lk, D), (B, Lq, D))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = _fused_attention_bwd_impl(*(jnp.asarray(a, jd) for a in (q, k, v, g)), H)
    got = flash_attention_bwd_reference(*(torch.from_numpy(a).to(td) for a in (q, k, v, g)), H)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == td and tuple(a.shape) == b.shape
        if dtype == "float32":
            np.testing.assert_allclose(to_np(a), to_np(b), err_msg=name, **FP32_TOL)
        else:
            # both sides round P and dS to bf16 and the outputs to bf16 at
            # the same points; another fp32 summation order can tip a value
            # across one bf16 rounding boundary: one bf16 ulp, 2^-8 of the
            # value (rtol 4e-3), or 2^-9 absolute near zero
            np.testing.assert_allclose(to_np(a), to_np(b), atol=2e-3, rtol=4e-3, err_msg=name)


@pytest.mark.parametrize("Lq,Lk,hd,route", [
    (129, 129, 64, "fused"),    # every shipped train shape at 129 tokens
    (160, 160, 64, "fused"),    # the fused kernel's longest
    (160, 160, 128, "fused"),   # ... at the widest head, 166,896 B of shared memory
    (161, 161, 64, "long"),
    (160, 161, 64, "long"),     # cross attention: either length past 160
    (161, 160, 128, "long"),
    (1, 160, 8, "fused"),       # a single query or key
    (160, 1, 24, "fused"),
    (1, 161, 64, "long"),
    (211, 129, 64, "long"),     # STRIDE_SIZE 12
    (1, 1, 8, "fused"),
])
def test_bwd_routes_by_length(Lq, Lk, hd, route):
    """The bf16 backward's route is chosen in host code: the fused kernel
    while both lengths are at most 160 and the head fits a block's shared
    memory, else the long route; fp32 has its own kernels."""
    from signal_tpu_torch.ops import flash_attention as fa

    assert fa.bwd_route(torch.bfloat16, Lq, Lk, hd) == route
    assert fa.bwd_route(torch.float32, Lq, Lk, hd) == "fp32"


def test_bwd_route_follows_the_source(monkeypatch):
    """The limits ``bwd_route`` uses are the CUDA source's: the fused
    kernel's length, its shared memory (Q, G, K and V at 144 rows while a
    register row of 136 keys takes Lk, else 160; 128-byte slabs of 64
    columns) and the route numbers; a head too large for a block's shared
    memory goes to the long route."""
    from pathlib import Path

    from signal_tpu_torch.ops import flash_attention as fa

    src = (Path(fa.__file__).parent.parent / "csrc" / "attention_bwd.cu").read_text()
    assert f"constexpr int kFusedMaxLen = {fa.BWD_FUSED_MAX_LEN};" in src
    assert f"if (route == {fa.BWD_ROUTES['fused']}) return launch_fused" in src
    assert f"if (route == {fa.BWD_ROUTES['long']}) {{" in src
    assert "return Lk <= 136 && mma::round16(Lq) <= 144 ? 17 : 20;" in src
    assert fa.bwd_fused_smem_bytes(129, 129, 64) == 76592        # three blocks an SM
    assert fa.bwd_fused_smem_bytes(160, 160, 128) == 166896
    assert fa.bwd_fused_smem_bytes(145, 17, 8) == 1024 + 4 * 160 * 128 + 12 * 160 + 112
    assert fa.bwd_fused_smem_bytes(144, 137, 8) == 1024 + 4 * 160 * 128 + 12 * 160 + 112
    assert fa.bwd_fused_smem_bytes(144, 136, 8) == 1024 + 4 * 144 * 128 + 12 * 144 + 112
    assert fa.bwd_fused_smem_bytes(9, 9, 72) == 1024 + 4 * 2 * 144 * 128 + 12 * 144 + 112
    assert fa.bwd_fused_smem_bytes(160, 160, 128) <= fa.SMEM_OPTIN_BYTES
    monkeypatch.setattr(fa, "SMEM_OPTIN_BYTES", 100_000)
    assert fa.bwd_route(torch.bfloat16, 160, 160, 128) == "long"
    assert fa.bwd_route(torch.bfloat16, 129, 129, 64) == "fused"


def test_fused_attention_has_a_gradient_on_the_cpu():
    """The operator's autograd formula carries the plain backward: gradients of
    ``flash_attention`` are the plain backward's, with the cotangent cast
    to the operand dtype (`flash_attention.py:206`)."""
    q, k, v, g = (torch.from_numpy(a) for a in
                  _arrays(3, (2, 9, 128), (2, 9, 128), (2, 9, 128), (2, 9, 128)))
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*qkv, num_heads=4, compute_dtype=torch.bfloat16)
    assert out.grad_fn is not None and out.dtype == torch.bfloat16
    got = torch.autograd.grad(out.float(), qkv, g)
    want = flash_attention_bwd_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                         g.bfloat16(), 4)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32      # the cast's VJP widens the bf16 gradient
        assert torch.equal(a, b.float())
    # the operator's own node, not an autograd Function of the caller's
    assert "signal_tpu_torch_attention_fwd" in type(out.grad_fn).__name__


def _grads_jax(fn, dt, q, k, v):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, num_heads=4, compute_dtype=dt).astype(jnp.float32) ** 2)
    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))


def _grads_port(fn, dt, q, k, v):
    qkv = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*qkv, num_heads=4, compute_dtype=dt)
    return torch.autograd.grad((out.float() ** 2).sum(), qkv)


def _core(q, k, v, *, num_heads, compute_dtype):
    return jatt._attention_core(q, k, v, num_heads, compute_dtype=compute_dtype)


def test_flash_attention_gradients_match_jax_fp32():
    q, k, v = _arrays(9, (2, 8, 32), (2, 8, 32), (2, 8, 32))
    got = _grads_port(flash_attention, torch.float32, q, k, v)
    want = _grads_jax(jax_flash, jnp.float32, q, k, v)
    core = _grads_jax(_core, jnp.float32, q, k, v)
    for a, b, c in zip(got, want, core):
        np.testing.assert_allclose(to_np(a), to_np(b), **FP32_TOL)
        # the eager core scales q before its dot: the JAX package's own
        # kernel-vs-core tolerance (`test_flash_attention.py:63-66`)
        np.testing.assert_allclose(to_np(a), to_np(c), atol=5e-4, rtol=1e-3)


def test_flash_attention_gradients_bf16_match_jax_and_track_fp32():
    q, k, v = _arrays(12, (2, 8, 32), (2, 8, 32), (2, 8, 32))
    got = _grads_port(flash_attention, torch.bfloat16, q, k, v)
    want = _grads_jax(jax_flash, jnp.bfloat16, q, k, v)
    truth = _grads_jax(_core, jnp.float32, q, k, v)
    for a, b, c in zip(got, want, truth):
        # same rounding points as the JAX kernel: the gradients are bf16
        # values widened, equal up to one bf16 ulp (2^-8 relative)
        np.testing.assert_allclose(to_np(a), to_np(b), atol=2e-3, rtol=8e-3)
        # and close to the fp32 truth (`test_flash_attention.py:69-79`)
        np.testing.assert_allclose(to_np(a), to_np(c), atol=0.15, rtol=0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_gradients_match_jax(dtype):
    """``linear``'s VJP: in fp32 a plain product; in bf16 the fp32
    cotangent dotted with the other bf16 operand in fp32, rounded to bf16,
    then widened by the cast (`jax.make_jaxpr` of JAX's VJP)."""
    x, kernel, bias, g = _arrays(4, (4, 7, 32), (32, 24), (24,), (4, 7, 24))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)

    def jloss(kernel, bias, x):
        return jnp.sum(jatt.linear(kernel, bias, x, jd) * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(kernel), jnp.asarray(bias),
                                             jnp.asarray(x))
    w = torch.from_numpy(kernel.T.copy()).requires_grad_(True)
    b = torch.from_numpy(bias).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tatt.linear(w, b, xt, td)
    gw, gb, gx = torch.autograd.grad(y, (w, b, xt), torch.from_numpy(g))
    assert gw.dtype == gx.dtype == torch.float32
    got = (gw.T, gb, gx)
    if dtype == "float32":
        tol = dict(atol=1e-5, rtol=1e-5)
    else:
        # the same fp32 products rounded once to bf16 on both sides: equal
        # up to one bf16 ulp where the fp32 sums' order tips a rounding
        tol = dict(atol=1e-6, rtol=8e-3)
    for name, a, c in zip(("kernel", "bias", "x"), got, want):
        np.testing.assert_allclose(to_np(a), to_np(c), err_msg=name, **tol)
    if dtype == "bfloat16":
        # the operand gradients are bf16 values (rounded once)
        assert torch.equal(gx, gx.bfloat16().float()) and torch.equal(gw, gw.bfloat16().float())

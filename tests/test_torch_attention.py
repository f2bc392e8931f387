"""Port parity: attention primitives and the fused-attention plain version.

``signal_tpu_torch.ops.flash_attention.flash_attention`` on CPU tensors runs
the plain PyTorch version of the CUDA kernel; here it is held against the
JAX package's ``flash_attention``, which runs the Pallas kernel in
interpret mode on the CPU (as `tests/test_flash_attention.py` runs it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu.ops import attention as jatt
from signal_tpu.ops.flash_attention import flash_attention as jax_flash
from signal_tpu_torch.ops import attention as tatt
from signal_tpu_torch.ops.flash_attention import (
    attention_fwd_cuda,
    flash_attention,
    flash_attention_reference,
)

from _torch_parity import to_np

# fp32: both sides run true-fp32 dots, so only summation order differs —
# the JAX package's own kernel-vs-core tolerance (`test_flash_attention.py`).
FP32_TOL = dict(atol=2e-5, rtol=1e-4)
# bf16: both sides round P and the output to bf16 at the same points; a
# different fp32 summation order can move a value across one bf16 rounding
# boundary, i.e. one bf16 ulp of outputs of magnitude < 4 (2^-6).
BF16_TOL = dict(atol=1.6e-2, rtol=0)


def _qkv(seed, B, Lq, Lk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Lq, D)).astype(np.float32),
            rng.standard_normal((B, Lk, D)).astype(np.float32),
            rng.standard_normal((B, Lk, D)).astype(np.float32))


@pytest.mark.parametrize("B,Lq,Lk,D,H,dtype", [
    (3, 9, 9, 32, 4, "float32"),        # self-attention, fp32
    (2, 16, 16, 64, 8, "bfloat16"),     # self-attention, bf16
    (4, 3, 24, 64, 8, "float32"),       # SIM-style cross attention, Lq != Lk
    (4, 3, 24, 64, 8, "bfloat16"),
    (2, 9, 9, 360, 6, "float32"),       # odd head dims (hd 60, 96, 64)
    (2, 9, 9, 384, 4, "float32"),
    (2, 9, 9, 256, 4, "float32"),
], ids=["fp32", "bf16", "cross-fp32", "cross-bf16", "hd60", "hd96", "hd64"])
def test_flash_attention_plain_matches_jax_kernel(B, Lq, Lk, D, H, dtype):
    q, k, v = _qkv(B * 100 + D, B, Lq, Lk, D)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=H,
                     compute_dtype=jnp.dtype(dtype))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          num_heads=H, compute_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, Lq, D)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)


def test_plain_version_scales_after_the_dot():
    """The kernel path scales the fp32 logits; the eager core scales q
    before the bf16 cast. In bf16 the two differ, and the port's plain
    version follows the kernel (it equals the JAX kernel exactly here)."""
    q, k, v = _qkv(7, 2, 16, 16, 64)
    qt, kt, vt = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    plain = flash_attention_reference(qt, kt, vt, 8)
    core = tatt._attention_core(qt.float(), kt.float(), vt.float(), 8, torch.bfloat16)
    jk = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=8)
    np.testing.assert_allclose(to_np(plain), to_np(jk), **BF16_TOL)
    assert np.abs(to_np(plain) - to_np(core)).max() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_core_matches_jax(dtype):
    q, k, v = _qkv(11, 2, 9, 12, 64)
    want = jatt._attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4,
                                compute_dtype=jnp.dtype(dtype))
    got = tatt._attention_core(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), 4, getattr(torch, dtype))
    # the core returns fp32 (bf16 operands, fp32 accumulation): summation
    # order only, plus at bf16 one rounding of P (2^-9 relative)
    tol = FP32_TOL if dtype == "float32" else dict(atol=1e-2, rtol=0)
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    ln = torch.nn.LayerNorm(48)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
    xj = jnp.asarray(x, jnp.dtype(dtype))
    want = jatt.layer_norm({"scale": jnp.asarray(w), "bias": jnp.asarray(b)}, xj)
    got = tatt.layer_norm(ln, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)  # returns the input dtype
    # fp32 statistics on both sides; bf16 outputs may differ by one ulp
    tol = dict(atol=2e-5, rtol=1e-5) if dtype == "float32" else dict(atol=0.05, rtol=1e-2)
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)


@pytest.mark.parametrize("dtype,out_dtype", [("float32", None), ("bfloat16", None),
                                             ("bfloat16", "bfloat16")])
def test_linear_matches_jax(dtype, out_dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 7, 32)).astype(np.float32)
    kernel = rng.standard_normal((32, 24)).astype(np.float32)   # JAX [in, out]
    bias = rng.standard_normal(24).astype(np.float32)
    want = jatt.linear(jnp.asarray(kernel), jnp.asarray(bias), jnp.asarray(x),
                       jnp.dtype(dtype), None if out_dtype is None else jnp.dtype(out_dtype))
    got = tatt.linear(torch.from_numpy(kernel.T.copy()), torch.from_numpy(bias),
                      torch.from_numpy(x), getattr(torch, dtype),
                      None if out_dtype is None else getattr(torch, out_dtype))
    assert got.dtype == (torch.float32 if out_dtype is None else getattr(torch, out_dtype))
    # fp32 accumulation of the same operand values on both sides; a bf16
    # output may differ by one ulp (|y| < 32 → 0.125)
    tol = dict(atol=1e-4, rtol=1e-5) if out_dtype is None else dict(atol=0.125, rtol=0)
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)


@pytest.mark.parametrize("use_flash", [True, False], ids=["kernel", "core"])
def test_mha_matches_jax(use_flash):
    rng = np.random.default_rng(3)
    D, H = 64, 4
    qkv = rng.standard_normal((D, 3 * D)).astype(np.float32) * 0.1
    qkv_b = rng.standard_normal(3 * D).astype(np.float32) * 0.1
    out_k = rng.standard_normal((D, D)).astype(np.float32) * 0.1
    out_b = rng.standard_normal(D).astype(np.float32) * 0.1
    xq = rng.standard_normal((2, 5, D)).astype(np.float32)
    xkv = rng.standard_normal((2, 11, D)).astype(np.float32)
    jp = {"qkv_kernel": jnp.asarray(qkv), "qkv_bias": jnp.asarray(qkv_b),
          "out_kernel": jnp.asarray(out_k), "out_bias": jnp.asarray(out_b)}
    want = jatt.mha(jp, jnp.asarray(xq), jnp.asarray(xkv), num_heads=H,
                    compute_dtype=jnp.float32, use_flash=use_flash)
    attn = tatt.MultiheadAttentionParams(D)
    with torch.no_grad():
        attn.in_proj_weight.copy_(torch.from_numpy(qkv.T.copy()))
        attn.in_proj_bias.copy_(torch.from_numpy(qkv_b))
        attn.out_proj.weight.copy_(torch.from_numpy(out_k.T.copy()))
        attn.out_proj.bias.copy_(torch.from_numpy(out_b))
    got = tatt.mha(attn, torch.from_numpy(xq), torch.from_numpy(xkv), num_heads=H,
                   compute_dtype=torch.float32, use_flash=use_flash)
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32_TOL)


def test_quick_gelu_matches_jax():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(to_np(tatt.quick_gelu(torch.from_numpy(x))),
                               to_np(jatt.quick_gelu(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors():
    """No fallback: the kernel's wrapper raises on tensors off the card."""
    q = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        attention_fwd_cuda(q, q, q, 4)
    assert attention_fwd_cuda.launches == 0

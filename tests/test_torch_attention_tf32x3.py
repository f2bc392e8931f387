"""The fp32 attention kernels' arithmetic, emulated on the CPU.

On the card the fp32 route of ``csrc/attention_bwd.cu`` forms every
product as 3xTF32 (``csrc/mma_tf32.cuh``): each fp32 operand a is split
into hi = tf32(a), rounded to nearest with ties away, and lo = a - hi,
which the tensor core reads truncated to tf32; a.b is then lo.hi' +
hi.lo' + hi.hi' with fp32 accumulation. No CPU runs that kernel, so this
file emulates the split in torch and runs the attention formulas with it
(the forward's too: the backward recomputes P with these products),
against the JAX package's Pallas kernels in interpret mode (as its own
tests run them) and against fp64. The fp32 forward route itself runs on
the CUDA cores, exact to fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu.ops.flash_attention import _fused_attention_bwd_impl, _fused_attention_fwd_impl
from signal_tpu_torch.ops import flash_attention as fa

from _torch_parity import to_np

# the kernels' tolerances against their plain versions (chip_smoke.py's
# FP32_TOL and BWD_FP32_TOL): summation order only
FP32_TOL = dict(atol=2e-5, rtol=1e-4)
BWD_FP32_TOL = dict(atol=1e-4, rtol=1e-4)
MASK = -0x2000  # 0xffffe000 as an int32: the bits a tf32 operand keeps


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """To nearest tf32, ties away from zero, on the int32 view."""
    return ((x.view(torch.int32) + 0x1000) & MASK).view(torch.float32)


def split(x: torch.Tensor):
    """x = hi + lo as the kernels split it: lo as the tensor core reads it,
    truncated to tf32."""
    hi = tf32_round(x)
    return hi, ((x - hi).view(torch.int32) & MASK).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: every product of two tf32 values is exact in fp32,
    the two small products first."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def heads(t: torch.Tensor, H: int) -> torch.Tensor:
    B, L, D = t.shape
    return t.view(B, L, H, D // H).transpose(1, 2)


def merge(t: torch.Tensor) -> torch.Tensor:
    B, H, L, hd = t.shape
    return t.transpose(1, 2).reshape(B, L, H * hd)


def probs(q, k, scale, matmul):
    logits = matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def attention_fwd(q, k, v, H, matmul=mm3):
    """The forward kernel's formula (`_attn_kernel`) with ``matmul``'s
    products; in fp32 the rounding of P is the identity."""
    scale = (q.shape[-1] // H) ** -0.5
    qh, kh, vh = (heads(t, H) for t in (q, k, v))
    return merge(matmul(probs(qh, kh, scale, matmul), vh))


def attention_bwd(q, k, v, g, H, matmul=mm3):
    """The backward kernels' formula (`_attn_bwd_kernel`): delta from dP
    and P, dQ and dK scaled after the product."""
    scale = (q.shape[-1] // H) ** -0.5
    qh, kh, vh, gh = (heads(t, H) for t in (q, k, v, g))
    p = probs(qh, kh, scale, matmul)
    dp = matmul(gh, vh.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return (merge(matmul(ds, kh) * scale), merge(matmul(ds.transpose(-1, -2), qh) * scale),
            merge(matmul(p.transpose(-1, -2), gh)))


def _arrays(seed, B, Lq, Lk, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Lq, D), (B, Lk, D), (B, Lk, D), (B, Lq, D))]


def test_tf32_rounding_and_split():
    """Ties go away from zero, values keep the top 19 bits, and hi + lo
    holds x to 2^-21 of it (lo truncated)."""
    one = 1.0
    ulp = 2.0 ** -10                       # a tf32 ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                      one + 1.5 * ulp, 3.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0])
    assert torch.equal(tf32_round(x), want)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(r)
    assert not (hi.view(torch.int32) & 0x1fff).any()
    assert not (lo.view(torch.int32) & 0x1fff).any()
    assert ((hi - r).abs() <= 2.0 ** -11 * r.abs()).all()
    assert ((hi.double() + lo.double() - r.double()).abs() <= 2.0 ** -21 * r.abs().double()).all()


# lengths across the kernels' 16-row tiles and chunks, past 256 keys (where
# the old kernels' shared memory and the bf16 forward's one pass end),
# cross attention both ways, head dims 8, 64 and 128
SHAPES = [(2, 9, 9, 128, 4), (1, 17, 33, 64, 1), (1, 129, 129, 64, 1), (1, 3, 300, 128, 1),
          (1, 40, 7, 16, 2), (1, 33, 17, 256, 2)]
SHAPE_IDS = ["self", "l17-33", "l129", "lk300-hd128", "lq40-lk7-hd8", "lq33-lk17-hd128"]


@pytest.mark.parametrize("B,Lq,Lk,D,H", SHAPES, ids=SHAPE_IDS)
def test_fwd_emulation_matches_jax_kernel(B, Lq, Lk, D, H):
    q, k, v, _ = _arrays(Lq * Lk + D, B, Lq, Lk, D)
    want = _fused_attention_fwd_impl(*(jnp.asarray(a) for a in (q, k, v)), H)
    got = attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)), H)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("B,Lq,Lk,D,H", SHAPES, ids=SHAPE_IDS)
def test_bwd_emulation_matches_jax_kernel(B, Lq, Lk, D, H):
    q, k, v, g = _arrays(Lq * Lk + D + 1, B, Lq, Lk, D)
    want = _fused_attention_bwd_impl(*(jnp.asarray(a) for a in (q, k, v, g)), H)
    got = attention_bwd(*(torch.from_numpy(a) for a in (q, k, v, g)), H)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(to_np(a), np.asarray(b), err_msg=name, **BWD_FP32_TOL)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_emulation_error_within_4x_of_plain_fp32(direction):
    """Against fp64 on the same inputs, 3xTF32 stays within 4x the plain
    fp32 version's error (the bound that decides between 3xTF32 and fp32
    FMAs on the CUDA cores)."""
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(7, 2, 129, 129, 128))
    f = attention_fwd if direction == "fwd" else attention_bwd
    args = (q, k, v) if direction == "fwd" else (q, k, v, g)
    ref = f(*(t.double() for t in args), 2, matmul=torch.matmul)
    emu = f(*args, 2)
    plain = (fa.flash_attention_reference(q, k, v, 2) if direction == "fwd"
             else fa.flash_attention_bwd_reference(q, k, v, g, 2))
    if direction == "fwd":
        ref, emu, plain = (ref,), (emu,), (plain,)
    for r, e, p in zip(ref, emu, plain):
        err = (e.double() - r).abs().max().item()
        err_plain = (p.double() - r).abs().max().item()
        assert 0 < err <= 4 * err_plain, (err, err_plain)


def test_fp32_routes_take_any_length():
    """fp32 takes its own route at every length in both directions (the
    fp32 kernels stream their keys or queries; the forward's wrapper
    raises past its shared memory); the source's route 0 is the one the
    host names."""
    from pathlib import Path

    for L in (129, 211, 300):
        assert fa.fwd_route(torch.float32, L) == "fp32"
        assert fa.bwd_route(torch.float32, L, L, 64) == "fp32"
        assert fa.bwd_route(torch.float32, L, 3, 128) == "fp32"
    csrc = Path(fa.__file__).parent.parent / "csrc"
    assert fa.FWD_ROUTES["fp32"] == fa.BWD_ROUTES["fp32"] == 0
    assert "return launch_fp32(q, k, v, o, B, H, Lq, Lk, hd, scale, s);" in \
        (csrc / "attention_fwd.cu").read_text()
    assert "return launch_fp32(q, k, v, g, dq, dk, dv, static_cast<float*>(stats)" in \
        (csrc / "attention_bwd.cu").read_text()

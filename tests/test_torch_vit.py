"""Port parity: the CLIP tower (`signal_tpu_torch.models.vit`) against
`signal_tpu.models.vit` on the same weights and images."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu.models import vit as jvit
from signal_tpu_torch.models import vit as tvit

from _torch_parity import IMG_HW, TINY, images, tiny_pair, to_np

# fp32: true-fp32 on both sides. The JAX tower's patch conv and final
# projection run at DEFAULT precision, which some CPUs take in bf16 passes;
# measured here, DEFAULT and HIGHEST give the same tower output (max gap
# to the port 2.5e-6 either way, |x| < 4), so summation order is the gap.
FP32_TOL = dict(atol=2e-5, rtol=1e-5)
# bf16: the residual stream, the MLP hidden and P are rounded to bf16 on
# both sides at the same points, but a different fp32 summation order can
# tip single roundings; over 2 blocks the measured gap is 1.1e-2 (|x| < 4)
BF16_TOL = dict(atol=5e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_forward_flash_matches_jax(dtype):
    jspec, params, _, model = tiny_pair(dtype, use_flash=True)
    rng = np.random.default_rng(0)
    x = images(rng, 3).reshape(9, 3, *IMG_HW)
    cv = rng.standard_normal((9, TINY["width"])).astype(np.float32) * 0.02
    jp, jc = jvit.vit_forward(params["base"], jnp.asarray(x), jnp.asarray(cv),
                              num_heads=TINY["num_heads"], compute_dtype=jnp.dtype(dtype),
                              use_flash=True, remat=False)
    with torch.inference_mode():
        tp, tc = tvit.vit_forward(model.clip_vision_encoder.base, torch.from_numpy(x),
                                  torch.from_numpy(cv), num_heads=TINY["num_heads"],
                                  compute_dtype=getattr(torch, dtype), use_flash=True)
    assert tp.shape == (9, TINY["h"] * TINY["w"], TINY["feat_dim"]) and tp.dtype == torch.float32
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(to_np(tp), to_np(jp), **tol)
    np.testing.assert_allclose(to_np(tc), to_np(jc), **tol)


def test_embed_patches_matches_jax_bf16_rounding():
    """The conv output is rounded to bf16 before the fp32 cast, then CLS,
    SIE and pos embed are added in fp32 and ln_pre runs in fp32."""
    _, params, _, model = tiny_pair("bfloat16")
    rng = np.random.default_rng(1)
    x = images(rng, 2).reshape(6, 3, *IMG_HW)
    cv = rng.standard_normal((6, TINY["width"])).astype(np.float32)
    want = jvit.embed_patches(params["base"], jnp.asarray(x), jnp.asarray(cv),
                              compute_dtype=jnp.bfloat16)
    with torch.inference_mode():
        got = tvit.embed_patches(model.clip_vision_encoder.base, torch.from_numpy(x),
                                 torch.from_numpy(cv), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    # both round the same conv sums to bf16; an fp32 sum order difference
    # can tip one rounding (one bf16 ulp before ln_pre's ~×10 gain)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=5e-2, rtol=1e-2)


def test_resize_pos_embed_matches_jax():
    h_new, w_new = 16, 8  # CLIP's 14×14 grid → the 256×128 ReID grid
    rng = np.random.default_rng(2)
    pos = rng.standard_normal((1 + 14 * 14, 32)).astype(np.float32)
    want = jvit.resize_pos_embed(jnp.asarray(pos), h_new, w_new)
    got = tvit.resize_pos_embed(torch.from_numpy(pos), h_new, w_new)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="not a square"):
        tvit.resize_pos_embed(torch.from_numpy(pos[:-1]), h_new, w_new)

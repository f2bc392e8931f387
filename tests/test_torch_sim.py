"""Port parity: SIM token selection and fusion, and the top-k mask ops.

The masks must be EXACTLY equal to the JAX package's, ties included: the
port takes the first k of a stable descending sort, which is
``lax.top_k``'s lowest-index-first order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu.models import sim as jsim
from signal_tpu.ops.topk_mask import exact_keep as jax_exact_keep
from signal_tpu.ops.topk_mask import topk_mask as jax_topk_mask
from signal_tpu_torch.models import sim as tsim
from signal_tpu_torch.ops import topk_mask as ttk

from _torch_parity import TINY, tiny_pair, to_np


def _tokens(seed, B, L, D, tied=False):
    rng = np.random.default_rng(seed)
    if tied:
        # few distinct token vectors → many exactly equal selection scores
        protos = rng.standard_normal((3, D)).astype(np.float32)
        patches = protos[rng.integers(0, 3, (B, 3, L))]
    else:
        patches = rng.standard_normal((B, 3, L, D)).astype(np.float32)
    cls = rng.standard_normal((B, 3, D)).astype(np.float32)
    return patches, cls


@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied-scores"])
@pytest.mark.parametrize("keep_ratio", [None, 0.5], ids=["union", "keep-ratio"])
def test_token_selection_masks_equal_jax(tied, keep_ratio):
    _, params, _, model = tiny_pair()
    D = TINY["feat_dim"]
    patches, cls = _tokens(3, 4, 8, D, tied=tied)
    jsel, jmask = jsim.token_selection(jnp.asarray(patches), jnp.asarray(cls),
                                       params["SIM"]["select"], k=3, keep_ratio=keep_ratio)
    tsel, tmask = tsim.token_selection(torch.from_numpy(patches), torch.from_numpy(cls),
                                       model.SIM.token_selection, k=3, keep_ratio=keep_ratio)
    np.testing.assert_array_equal(to_np(tmask), to_np(jmask))
    np.testing.assert_array_equal(to_np(tsel), to_np(jsel))
    if tied:  # the fixture really produces boundary ties
        scores = np.einsum("bmd,bmld->bml", cls, patches)
        assert any(len(np.unique(row)) < row.size for row in scores.reshape(-1, 8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sim_forward_matches_jax(dtype):
    _, params, _, model = tiny_pair(dtype)
    patches, cls = _tokens(4, 3, 8, TINY["feat_dim"])
    jf, jm = jsim.sim_forward(params["SIM"], jnp.asarray(patches), jnp.asarray(cls),
                              k=3, compute_dtype=jnp.dtype(dtype))
    with torch.inference_mode():
        tf, tm = tsim.sim_forward(model.SIM, torch.from_numpy(patches), torch.from_numpy(cls),
                                  k=3, compute_dtype=getattr(torch, dtype))
    for name in ("RGB", "NI", "TI"):
        np.testing.assert_array_equal(to_np(tm[name]), to_np(jm[name]))
    # fp32: summation order only; bf16: operand roundings at the same
    # points, one bf16 ulp tipped here and there before the two fp32 LNs
    tol = dict(atol=2e-5, rtol=1e-5) if dtype == "float32" else dict(atol=3e-2, rtol=1e-2)
    np.testing.assert_allclose(to_np(tf), to_np(jf), **tol)


def test_topk_mask_ties_lowest_index_first_like_lax():
    vals = np.random.default_rng(5).integers(0, 3, (64, 12)).astype(np.float32)
    for k in (1, 4, 7, 11):
        np.testing.assert_array_equal(to_np(ttk.topk_mask(torch.from_numpy(vals), k)),
                                      to_np(jax_topk_mask(jnp.asarray(vals), k)))


def test_exact_keep_matches_jax_under_ties():
    rng = np.random.default_rng(6)
    scores = rng.integers(0, 3, (64, 12)).astype(np.float32)
    mask = (rng.random((64, 12)) < 0.5).astype(np.float32)
    for keep in (2, 6, 9):
        np.testing.assert_array_equal(
            to_np(ttk.exact_keep(torch.from_numpy(mask), torch.from_numpy(scores), keep)),
            to_np(jax_exact_keep(jnp.asarray(mask), jnp.asarray(scores), keep)))

"""Port parity: the device-side train augmentation. The JAX package's
draws (the same ``jax.random`` calls ``augment_batch`` makes on the same
key) are replayed through the port's apply functions, and the outputs must
equal JAX's ``augment_batch`` exactly."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu.data.augment import augment_batch as jax_augment
from signal_tpu_torch.data import augment as ta

from _torch_parity import to_np

FILL = (-1.0, -0.5, 0.25)


def _jax_draws(key, x_shape, pad, min_area=0.02, max_area=1 / 3, min_aspect=0.3):
    """The variates `signal_tpu/data/augment.py` draws for one modality."""
    B = x_shape[0]
    kf, kc, ke = jax.random.split(key, 3)
    ky, kx = jax.random.split(kc)
    ks = jax.random.split(ke, 6)
    la0, la1 = jnp.log(min_aspect), jnp.log(1.0 / min_aspect)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  (a writable copy)
    return (t(jax.random.uniform(kf, (B,))),
            (t(jax.random.randint(ky, (B,), 0, 2 * pad + 1)),
             t(jax.random.randint(kx, (B,), 0, 2 * pad + 1))),
            {"area": t(jax.random.uniform(ks[0], (B, 10), minval=min_area, maxval=max_area)),
             "aspect": t(jnp.exp(jax.random.uniform(ks[1], (B, 10), minval=la0, maxval=la1))),
             "u_top": t(jax.random.uniform(ks[2], (B,))),
             "u_left": t(jax.random.uniform(ks[3], (B,))),
             "u_do": t(jax.random.uniform(ks[4], (B,))),
             "noise": t(jax.random.normal(ks[5], x_shape, jnp.float32))})


@pytest.mark.parametrize("flip_prob,re_prob,pad", [(0.5, 0.5, 3), (1.0, 1.0, 2)])
def test_apply_functions_replay_jax_draws_exactly(flip_prob, re_prob, pad):
    rng = np.random.default_rng(0)
    imgs = {m: rng.standard_normal((6, 3, 16, 8)).astype(np.float32) for m in ("RGB", "NI", "TI")}
    key = jax.random.PRNGKey(3)
    want = jax_augment(key, {m: jnp.asarray(x) for m, x in imgs.items()},
                       flip_prob=flip_prob, re_prob=re_prob, padding=pad, fill=FILL)
    erased = 0
    for i, name in enumerate(sorted(imgs)):
        u_flip, (ty, tx), erase = _jax_draws(jax.random.fold_in(key, i), imgs[name].shape, pad)
        x = ta.apply_flip(torch.from_numpy(imgs[name]), u_flip, flip_prob)
        x = ta.apply_pad_crop(x, ty, tx, pad, torch.tensor(FILL))
        x = ta.apply_erase(x, erase, re_prob)
        np.testing.assert_array_equal(to_np(x), to_np(want[name]), err_msg=name)
        erased += int((to_np(x) == to_np(erase["noise"])).all(axis=1).any())
    assert erased > 0          # some samples took the erase branch


def test_port_draws_are_seeded_and_shaped():
    imgs = {m: torch.zeros(4, 3, 16, 8) for m in ("RGB", "NI", "TI")}
    kw = dict(flip_prob=0.5, re_prob=0.5, padding=2, fill=FILL)
    a = ta.augment_batch(torch.Generator().manual_seed(1), imgs, **kw)
    b = ta.augment_batch(torch.Generator().manual_seed(1), imgs, **kw)
    c = ta.augment_batch(torch.Generator().manual_seed(2), imgs, **kw)
    assert all(torch.equal(a[m], b[m]) for m in imgs)
    assert any(not torch.equal(a[m], c[m]) for m in imgs)
    assert all(a[m].shape == (4, 3, 16, 8) for m in imgs)
    d = ta.erase_draws(torch.Generator().manual_seed(0), (64, 3, 16, 8), "cpu")
    assert d["area"].min() >= 0.02 and d["area"].max() <= 1 / 3
    assert d["aspect"].min() >= 0.3 - 1e-6 and d["aspect"].max() <= 1 / 0.3 + 1e-5
    assert math.isclose(float(d["noise"].std()), 1.0, rel_tol=0.1)


def test_pad_crop_fills_with_the_normalized_zero():
    x = torch.ones(1, 3, 4, 4)
    out = ta.apply_pad_crop(x, torch.tensor([0]), torch.tensor([0]), 2, torch.tensor(FILL))
    # the crop at (0, 0) of the padded image: two rows and columns of fill
    for c, f in enumerate(FILL):
        assert (out[0, c, :2] == f).all() and (out[0, c, 2:, 2:] == 1.0).all()

"""Port parity: the REMAT policies of the CLIP tower.

For each MODEL.REMAT_POLICY the tiny fp32 tower's gradients equal the
port's own without remat (remat changes memory and recompute, never the
numbers) and JAX ``vit_forward``'s under the same policy. What each
policy recomputes is held by counting: the forward attention calls of one
backward (the launches of the kernel on the card) and the products the
backward runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from signal_tpu.models import vit as jvit
from signal_tpu_torch.models import vit as tvit
from signal_tpu_torch.models.convert import state_dict_from_jax
from signal_tpu_torch.ops import flash_attention as fa

from _torch_parity import IMG_HW, TINY, images, tiny_pair, to_np

POLICIES = ["full", "dots", "attn", "attn_mlp", "half"]
LAYERS = TINY["layers"]
# forward attention calls per tower pass: every recomputed block runs it
# again (the out-proj's weight gradient needs the core's output); 'half'
# recomputes the first layers // 2 blocks only
ATTENTION_CALLS = {None: LAYERS, "full": 2 * LAYERS, "dots": 2 * LAYERS, "attn": 2 * LAYERS,
                   "attn_mlp": 2 * LAYERS, "half": LAYERS + LAYERS // 2}


@pytest.fixture(scope="module")
def tower():
    jspec, params, bn, model = tiny_pair("float32", use_flash=True)
    rng = np.random.default_rng(0)
    x = images(rng, 2).reshape(6, 3, *IMG_HW)
    cv = (rng.standard_normal((6, TINY["width"])) * 0.02).astype(np.float32)
    return jspec, params, bn, model.clip_vision_encoder.base, x, cv


def _port_grads(tower, policy):
    """→ (loss, {name: grad}, forward attention calls, backward mm count)
    of a smooth loss of the tower; ``policy`` None: remat off."""
    _, _, _, vit, x, cv = tower
    calls = []
    plain = fa.flash_attention_reference

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    fa.flash_attention_reference = counted
    try:
        p, c = tvit.vit_forward(vit, torch.from_numpy(x), torch.from_numpy(cv),
                                num_heads=TINY["num_heads"], compute_dtype=torch.float32,
                                use_flash=True, remat=policy is not None,
                                remat_policy=policy or "full")
        loss = p.square().mean() + c.square().mean()
        with _CountProducts() as products:
            grads = torch.autograd.grad(loss, list(vit.parameters()))
    finally:
        fa.flash_attention_reference = plain
    names = [n for n, _ in vit.named_parameters()]
    return loss.item(), dict(zip(names, grads)), len(calls), products.n


class _CountProducts(TorchDispatchMode):
    """Counts the 2-D products (``aten.mm``) dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func.overloadpacket is torch.ops.aten.mm
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def no_remat(tower):
    return _port_grads(tower, None)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_gradients_equal_no_remat_and_jax(tower, no_remat, policy):
    jspec, params, bn, _, x, cv = tower
    loss, grads, calls, _ = _port_grads(tower, policy)
    # the same ops on the same values: bit for bit the tower without remat
    assert loss == no_remat[0]
    for name, g in grads.items():
        assert torch.equal(g, no_remat[1][name]), name
    assert calls == ATTENTION_CALLS[policy]

    def jloss(base):
        p, c = jvit.vit_forward(base, jnp.asarray(x), jnp.asarray(cv),
                                num_heads=TINY["num_heads"], compute_dtype=jnp.float32,
                                use_flash=True, remat=True, remat_policy=policy)
        return jnp.mean(p ** 2) + jnp.mean(c ** 2)

    jl, jg = jax.value_and_grad(jloss)(params["base"])
    sd = state_dict_from_jax(jax.tree.map(np.asarray, {**params, "base": jg}),
                             jax.tree.map(np.asarray, bn), jspec)
    pre = "clip_vision_encoder.base."
    assert loss == pytest.approx(float(jl), rel=1e-5)
    for name, g in grads.items():
        a, b = to_np(g), to_np(sd[pre + name])
        # fp32 on both sides: summation order only (measured 9e-7)
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-4, name


def test_no_remat_runs_each_attention_once(no_remat):
    assert no_remat[2] == ATTENTION_CALLS[None]


def test_dots_recomputes_no_product(tower, no_remat):
    """'dots' keeps every product's output: its backward runs the products
    of the tower without remat and none more; 'full' recomputes them."""
    assert _port_grads(tower, "dots")[3] == no_remat[3]
    assert _port_grads(tower, "full")[3] > no_remat[3]


def test_unknown_remat_policy_raises(tower):
    vit, x = tower[3], torch.from_numpy(tower[4])
    with pytest.raises(ValueError, match="REMAT_POLICY"):
        tvit.vit_forward(vit, x, num_heads=TINY["num_heads"], compute_dtype=torch.float32,
                         remat=True, remat_policy="everything")

"""Port parity: CLIP-ReID (`signal_tpu_torch.models.{tokenizer,text_encoder,
clipreid}`), the masked attention core, ``vit_forward(return_intermediate=
True)``, ``supcon_loss``/``i2t_cross_entropy`` and the CLIP text importer,
against `signal_tpu` on the same seeded inputs.

The JAX tree comes from ``init_clipreid_params`` with the text tower
shrunk (width 64, 2 layers; CLIP's 49,408-row vocabulary and 77 positions
kept, so the real tokenizer's ids index it) on a 2-layer image tower of
width 128 (4 heads) over 64×32 images, and crosses into the port through
``clipreid_state_dict_from_jax`` (``strict=True``)."""

import dataclasses
import functools
import hashlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu import losses as jl
from signal_tpu.models import clipreid as jcr
from signal_tpu.models import text_encoder as jte
from signal_tpu.models import tokenizer as jtok
from signal_tpu.models import vit as jvit
from signal_tpu.ops import attention as jatt
from signal_tpu_torch import losses as tl
from signal_tpu_torch.models import clipreid as tcr
from signal_tpu_torch.models import text_encoder as tte
from signal_tpu_torch.models import tokenizer as ttok
from signal_tpu_torch.models import vit as tvit
from signal_tpu_torch.models.clip_loader import load_clip_into_clipreid
from signal_tpu_torch.models.convert import clipreid_state_dict_from_jax
from signal_tpu_torch.ops import attention as tatt

from _torch_parity import to_np

REPO = Path(__file__).resolve().parent.parent
SIZES = dict(num_classes=5, camera_num=3, width=128, proj_dim=64, layers=2, num_heads=4,
             h=4, w=2, sie_coe=3.0, compute_dtype="float32", use_flash=True)
TEXT = dict(width=64, layers=2)
IMG_HW = (64, 32)
# fp32 on both sides: summation order only (tests/test_torch_model.py)
FP32 = dict(atol=2e-5, rtol=1e-5)

TEXTS = ["A photo of a X X X X person.", "A photo of a X X X X vehicle.",
         "a &amp;quot;bad&amp;quot; photo &lt;of&gt; the car!",
         "  spaced\tout \n\n words  ", "Café naïve façade — 東京 ünïcödé ŝtrïñg",
         "it's 2 o'clock, they'll've 3.14 x42y", "ÆØÅ æøå ßẞ ﬁ Ǆ ǅ ǆ"]


@pytest.fixture(scope="module")
def pair():
    """→ (JAX spec, params, bn, port spec, port ClipReID in fp32)."""
    jspec = jcr.ClipReIDSpec(**SIZES)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcr, "init_text_params", functools.partial(jte.init_text_params, **TEXT))
        params, bn = jax.jit(lambda key: jcr.init_clipreid_params(key, jspec))(
            jax.random.PRNGKey(0))
    # the BNNecks' running statistics off their init, so eval's 'after' reads them
    rng = np.random.default_rng(9)
    for name, d in (("bottleneck", 128), ("bottleneck_proj", 64)):
        bn[name] = {"mean": jnp.asarray(0.1 * rng.standard_normal(d), jnp.float32),
                    "var": jnp.asarray(rng.uniform(0.5, 1.5, d), jnp.float32)}
    tspec = tcr.ClipReIDSpec(**SIZES, text_width=TEXT["width"], text_layers=TEXT["layers"])
    model = tcr.ClipReID(tspec)
    model.load_state_dict(clipreid_state_dict_from_jax(jax.tree.map(np.asarray, params),
                                                       jax.tree.map(np.asarray, bn)),
                          strict=True)
    return jspec, params, bn, tspec, model


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _images(seed, batch=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, 3, *IMG_HW)).astype(np.float32),
            rng.integers(0, SIZES["camera_num"], batch))


# ---------------------------------------------------------------------------
# tokenizer


def test_vocabulary_is_the_jax_packages_copy():
    ours = REPO / "signal_tpu_torch/models/data/bpe_simple_vocab_16e6.txt.gz"
    theirs = REPO / "signal_tpu/models/data/bpe_simple_vocab_16e6.txt.gz"
    assert hashlib.sha256(ours.read_bytes()).hexdigest() == \
        hashlib.sha256(theirs.read_bytes()).hexdigest()
    assert Path(ttok.resolve_bpe_path()) == ours
    tok = ttok.ClipTokenizer()
    assert tok.has_merges and len(tok.encoder) == 49408
    assert tok.encode("a photo of a") == [320, 1125, 539, 320]


@pytest.mark.parametrize("branch", ["regex", "ascii"])
def test_tokenizer_ids_match_jax(branch, monkeypatch):
    """Both pre-tokenizing branches: with ``regex`` (``\\p{L}``/``\\p{N}``)
    and without it (the ASCII pattern, and the standard ``re`` for
    everything, as the JAX module runs where ``regex`` is missing)."""
    if branch == "ascii":
        monkeypatch.setattr(ttok, "_HAS_REGEX", False)
        monkeypatch.setattr(jtok, "_HAS_REGEX", False)
        monkeypatch.setattr(jtok, "re", re)
    ours, theirs = ttok.ClipTokenizer(), jtok.ClipTokenizer()
    for text in TEXTS:
        assert ours.encode(text) == theirs.encode(text), text
    ids = ours.tokenize(TEXTS)
    assert ids.dtype == torch.long and ids.shape == (len(TEXTS), 77)
    np.testing.assert_array_equal(ids.numpy(), theirs.tokenize(TEXTS))
    too_long = "photo " * 80
    for tok in (ours, theirs):
        with pytest.raises(RuntimeError, match="too long for context 77"):
            tok.tokenize(too_long)


def test_byte_fallback_vocabulary_matches_jax(monkeypatch):
    monkeypatch.setattr(ttok, "resolve_bpe_path", lambda p=None: None)
    monkeypatch.setattr(jtok, "resolve_bpe_path", lambda p=None: None)
    ours, theirs = ttok.ClipTokenizer(), jtok.ClipTokenizer()
    assert not ours.has_merges and len(ours.encoder) == len(theirs.encoder) == 514
    for text in TEXTS:
        assert ours.encode(text) == theirs.encode(text), text
    ids = ours.tokenize(TEXTS[0])[0]
    eot = int(ids.argmax())
    assert ids[0] == ours.sot_token and ids[eot] == ours.eot_token
    assert "photo" in ours.decode(ids[1:eot].tolist())


def test_decode_round_trips():
    tok = ttok.ClipTokenizer()
    for text in TEXTS:
        want = " ".join(tok.pat.findall(ttok._whitespace_clean(ttok._basic_clean(text))
                                        .lower()))
        got = tok.decode(tok.encode(text))
        assert got.replace(" ", "") == want.replace(" ", ""), text


# ---------------------------------------------------------------------------
# the masked attention core and the text tower


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_core_matches_jax(dtype):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((3, 11, 64)).astype(np.float32) for _ in range(3))
    mask = tte.causal_mask(11)
    assert torch.equal(mask, torch.from_numpy(np.asarray(jte.causal_mask(11))))
    want = jatt._attention_core(*(jnp.asarray(t) for t in (q, k, v)), 8,
                                compute_dtype=jnp.dtype(dtype), mask=jte.causal_mask(11))
    got = tatt._attention_core(*(torch.from_numpy(t) for t in (q, k, v)), 8,
                               getattr(torch, dtype), mask=mask)
    tol = FP32 if dtype == "float32" else dict(atol=1e-2, rtol=0)   # one rounding of P
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)
    # the first query sees only the first key: its output is that value
    first = torch.from_numpy(v[:, 0]).to(getattr(torch, dtype)).float()
    np.testing.assert_array_equal(to_np(got)[:, 0], to_np(first))


def test_mha_with_a_mask_takes_the_eager_core(monkeypatch):
    """``use_flash`` with a mask runs the eager core (JAX's rule): the
    kernel's operator is never reached."""
    from signal_tpu_torch.ops import flash_attention as fa

    def refuse(*a, **k):
        raise AssertionError("the kernel path took a masked attention")

    monkeypatch.setattr(fa, "flash_attention", refuse)
    attn = tatt.MultiheadAttentionParams(64)
    attn.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 7, 64)
    out = tatt.mha(attn, x, num_heads=8, compute_dtype=torch.float32, use_flash=True,
                   mask=tte.causal_mask(7))
    assert out.shape == (2, 7, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_tower_matches_jax_and_is_causal(pair, dtype):
    _, params, _, _, model = pair
    rng = np.random.default_rng(2)
    prompts = rng.standard_normal((3, 77, TEXT["width"])).astype(np.float32)
    tokenized = np.asarray(model.prompt_learner.tokenized.expand(3, -1))
    want = jax.jit(functools.partial(jte.text_forward, num_heads=8,
                                     compute_dtype=jnp.dtype(dtype)))(
        params["text"], jnp.asarray(prompts), jnp.asarray(tokenized))
    got = tte.text_forward(model.text, torch.from_numpy(prompts),
                           torch.from_numpy(tokenized), num_heads=8,
                           compute_dtype=getattr(torch, dtype))
    assert got.shape == (3, SIZES["proj_dim"]) and got.dtype == torch.float32
    tol = FP32 if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)
    # a position after EOT moved by 10 along a random direction (a shift of
    # all channels alike would vanish in the LayerNorms) leaves the features
    # as they were; one before it moves them
    eot = int(tokenized[0].argmax())
    kick = 10.0 * rng.standard_normal(TEXT["width"]).astype(np.float32)

    def moved(pos):
        p = prompts.copy()
        p[:, pos] += kick
        return tte.text_forward(model.text, torch.from_numpy(p), torch.from_numpy(tokenized),
                                num_heads=8, compute_dtype=getattr(torch, dtype))

    torch.testing.assert_close(moved(eot + 1), got, atol=1e-6, rtol=0)
    assert not torch.allclose(moved(eot - 1), got, atol=1e-3)


def test_prompt_learner_matches_jax(pair):
    _, params, _, _, model = pair
    pl = model.prompt_learner
    assert {n for n, _ in pl.named_parameters()} == {"cls_ctx"}
    assert {n for n, _ in pl.named_buffers()} == {"token_prefix", "token_suffix", "tokenized"}
    labels = np.array([4, 0, 2, 2])
    jp, jt = jte.prompt_forward(params["prompt_learner"], jnp.asarray(labels))
    tp, tt = tte.prompt_forward(pl, torch.from_numpy(labels))
    np.testing.assert_array_equal(to_np(tp), to_np(jp))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # the template's rows of the token embedding, from a fresh build too
    fresh = tte.PromptLearner(5, "RGBNT201", model.text.token_embedding.weight,
                              ttok.ClipTokenizer())
    for name in ("token_prefix", "token_suffix", "tokenized"):
        assert torch.equal(getattr(fresh, name), getattr(pl, name)), name
    assert tte.PromptLearner(5, "RGBNT100", model.text.token_embedding.weight,
                             ttok.ClipTokenizer()).noun == "vehicle"


# ---------------------------------------------------------------------------
# the image tower's intermediate outputs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_return_intermediate_matches_jax(pair, dtype):
    _, params, _, _, model = pair
    x, cams = _images(3)
    cv = 3.0 * np.asarray(params["cv_embed"])[cams]
    want = jax.jit(functools.partial(jvit.vit_forward, num_heads=4,
                                     compute_dtype=jnp.dtype(dtype), use_flash=True,
                                     return_intermediate=True, stride=16))(
        params["base"], jnp.asarray(x), jnp.asarray(cv))
    with torch.no_grad():
        got = tvit.vit_forward(model.base, torch.from_numpy(x), torch.from_numpy(cv),
                               num_heads=4, compute_dtype=getattr(torch, dtype),
                               use_flash=True, stride=16, return_intermediate=True)
    assert len(got) == 3
    for name, g, w, gdt in zip(("x_last", "x_post", "x_proj"), got, want,
                               (getattr(torch, dtype), getattr(torch, dtype), torch.float32)):
        assert g.dtype == gdt and g.shape == w.shape == (4, 9, g.shape[-1]), name
        tol = FP32 if dtype == "float32" else dict(atol=5e-2, rtol=2e-2)
        np.testing.assert_allclose(to_np(g), to_np(w), err_msg=name, **tol)
    # the default return is the same projection split into patches and CLS
    with torch.no_grad():
        patches, cls = tvit.vit_forward(model.base, torch.from_numpy(x), torch.from_numpy(cv),
                                        num_heads=4, compute_dtype=getattr(torch, dtype),
                                        use_flash=True, stride=16)
    assert torch.equal(patches, got[2][:, 1:]) and torch.equal(cls, got[2][:, 0])


@pytest.mark.parametrize("policy", ["full", "dots", "attn", "attn_mlp", "half"])
def test_return_intermediate_under_every_remat_policy(pair, policy):
    """Remat moves no number: every policy's triple and its gradients equal
    the tower's without remat."""
    _, _, _, _, model = pair
    x = torch.from_numpy(_images(4, 2)[0])

    def run(remat):
        model.zero_grad()
        out = tvit.vit_forward(model.base, x, num_heads=4, compute_dtype=torch.float32,
                               use_flash=True, remat=remat, remat_policy=policy,
                               return_intermediate=True)
        sum(o.square().mean() for o in out).backward()
        return [o.detach() for o in out], [p.grad.clone() for p in model.base.parameters()]

    (o1, g1), (o0, g0) = run(True), run(False)
    model.zero_grad()
    for a, b in zip(o1 + g1, o0 + g0):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# the model functions


def test_forward_train_matches_jax(pair):
    jspec, params, bn, _, model = pair
    state0 = _state(model)
    x, cams = _images(5)
    jscores, jfeats, jproj, jbn = jax.jit(jcr.clipreid_forward_train, static_argnums=2)(
        params, bn, jspec, jnp.asarray(x), jnp.asarray(cams))
    with torch.no_grad():
        scores, feats, proj = tcr.clipreid_forward_train(model, torch.from_numpy(x),
                                                         torch.from_numpy(cams))
    try:
        assert [tuple(s.shape) for s in scores] == [(4, 5), (4, 5)]
        assert [tuple(f.shape) for f in feats] == [(4, 128), (4, 128), (4, 64)]
        for g, w in zip(scores + feats + [proj], jscores + jfeats + [jproj]):
            np.testing.assert_allclose(to_np(g), to_np(w), **FP32)
        for name in ("bottleneck", "bottleneck_proj"):
            bnm = getattr(model, name)
            np.testing.assert_allclose(to_np(bnm.running_mean), to_np(jbn[name]["mean"]), **FP32)
            np.testing.assert_allclose(to_np(bnm.running_var), to_np(jbn[name]["var"]), **FP32)
            assert not torch.equal(bnm.running_mean, state0[f"{name}.running_mean"])
    finally:
        model.load_state_dict(state0)


@pytest.mark.parametrize("neck_feat", ["before", "after"])
def test_forward_eval_matches_jax(pair, neck_feat):
    jspec, params, bn, tspec, model = pair
    model.spec = dataclasses.replace(tspec, neck_feat=neck_feat)
    state0 = _state(model)
    x, cams = _images(6)
    want = jax.jit(jcr.clipreid_forward_eval, static_argnums=2)(
        params, bn, dataclasses.replace(jspec, neck_feat=neck_feat), jnp.asarray(x),
        jnp.asarray(cams))
    try:
        with torch.inference_mode():
            got = tcr.clipreid_forward_eval(model, torch.from_numpy(x), torch.from_numpy(cams))
        assert got.shape == (4, 128 + 64) and got.dtype == torch.float32
        np.testing.assert_allclose(to_np(got), to_np(want), **FP32)
        for k, v in model.state_dict().items():   # eval moves no statistic
            assert torch.equal(v, state0[k]), k
    finally:
        model.spec = tspec


def test_eval_joins_a_bf16_and_an_fp32_feature_as_fp32(pair):
    _, _, _, tspec, model = pair
    model.spec = dataclasses.replace(tspec, compute_dtype="bfloat16")
    try:
        with torch.inference_mode():
            got = tcr.clipreid_forward_eval(model, torch.from_numpy(_images(7)[0]))
    finally:
        model.spec = tspec
    assert got.dtype == torch.float32 and got.shape == (4, 192)


def test_text_and_image_features_match_jax(pair):
    jspec, params, _, _, model = pair
    labels = np.array([0, 3, 4, 1, 3])
    want = jax.jit(jcr.clipreid_text_features, static_argnums=1)(params, jspec,
                                                                 jnp.asarray(labels))
    x, cams = _images(8)
    want_img = jax.jit(jcr.clipreid_image_features, static_argnums=1)(
        params, jspec, jnp.asarray(x), jnp.asarray(cams))
    with torch.no_grad():
        got = tcr.clipreid_text_features(model, torch.from_numpy(labels))
        got_img = tcr.clipreid_image_features(model, torch.from_numpy(x),
                                              torch.from_numpy(cams))
    assert got.shape == (5, 64) and got_img.shape == (4, 64)
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32)
    np.testing.assert_allclose(to_np(got_img), to_np(want_img), **FP32)


# ---------------------------------------------------------------------------
# losses and one composed loss's gradients


def test_supcon_and_i2t_match_jax():
    rng = np.random.default_rng(10)
    t, i, c = (rng.standard_normal(s).astype(np.float32) for s in ((6, 16), (8, 16), (5, 16)))
    tlab, ilab = np.array([0, 1, 2, 0, 1, 4]), np.array([0, 0, 1, 1, 2, 2, 3, 3])

    def both(jfn, tfn, arrays):
        jv, jg = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
            *(jnp.asarray(a) for a in arrays))
        ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        tv = tfn(*ts)
        tg = torch.autograd.grad(tv, ts)
        np.testing.assert_allclose(to_np(tv), to_np(jv), rtol=1e-5, atol=1e-6)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-5, atol=1e-6)

    for temp in (1.0, 0.1):
        both(lambda a, b: jl.supcon_loss(a, b, jnp.asarray(tlab), jnp.asarray(ilab), temp),
             lambda a, b: tl.supcon_loss(a, b, torch.from_numpy(tlab), torch.from_numpy(ilab),
                                         temp), [t, i])
    lab = np.array([0, 4, 2, 2, 1, 3, 0, 1])
    both(lambda a, b: jl.i2t_cross_entropy(a, b, jnp.asarray(lab)),
         lambda a, b: tl.i2t_cross_entropy(a, b, torch.from_numpy(lab)), [i, c])


def _composed_loss_jax(fparams, tokenized, bn, spec, x, cams, pids):
    params = dict(fparams, prompt_learner=dict(fparams["prompt_learner"], tokenized=tokenized))
    scores, feats, proj, _ = jcr.clipreid_forward_train(params, bn, spec, x, cams)
    text_all = jax.lax.stop_gradient(
        jcr.clipreid_text_features(params, spec, jnp.arange(spec.num_classes)))
    text_b = jcr.clipreid_text_features(params, spec, pids)
    return (sum(jl.cross_entropy(s, pids) for s in scores)
            + sum(jl.triplet_loss(f, pids, 0.3)[0] for f in feats)
            + jl.i2t_cross_entropy(proj, text_all, pids)
            + jl.supcon_loss(text_b, proj, pids, pids) + jl.supcon_loss(proj, text_b, pids, pids))


def _composed_loss_torch(model, x, cams, pids):
    scores, feats, proj = tcr.clipreid_forward_train(model, x, cams)
    with torch.no_grad():
        text_all = tcr.clipreid_text_features(model, torch.arange(model.spec.num_classes))
    text_b = tcr.clipreid_text_features(model, pids)
    return (sum(tl.cross_entropy(s, pids) for s in scores)
            + sum(tl.triplet_loss(f, pids, 0.3)[0] for f in feats)
            + tl.i2t_cross_entropy(proj, text_all, pids)
            + tl.supcon_loss(text_b, proj, pids, pids) + tl.supcon_loss(proj, text_b, pids, pids))


def test_composed_loss_gradients_match_jax(pair):
    """The loss ``chip_smoke.py`` trains with (CE on both scores, triplet on
    the three features, image-to-text CE against every class's text
    features, SupCon both ways with the batch's text features): its value
    at rtol 1e-5 and every port parameter's gradient at relative L2 < 1e-4
    against ``jax.grad`` (remat 'full' on the port's image tower)."""
    jspec, params, bn, _, model = pair
    state0 = _state(model)
    x, cams = _images(11)
    pids = np.repeat(np.array([3, 0]), 2)
    fparams = dict(params, prompt_learner={k: v for k, v in params["prompt_learner"].items()
                                           if k != "tokenized"})
    jloss, jgrads = jax.jit(jax.value_and_grad(_composed_loss_jax), static_argnums=3)(
        fparams, params["prompt_learner"]["tokenized"], bn, jspec, jnp.asarray(x),
        jnp.asarray(cams), jnp.asarray(pids))
    try:
        model.zero_grad()
        loss = _composed_loss_torch(model, torch.from_numpy(x), torch.from_numpy(cams),
                                    torch.from_numpy(pids))
        loss.backward()
    finally:
        model.load_state_dict(state0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jgrads = dict(jgrads, prompt_learner=dict(jgrads["prompt_learner"],
                                              tokenized=params["prompt_learner"]["tokenized"]))
    want = clipreid_state_dict_from_jax(jax.tree.map(np.asarray, jgrads),
                                        jax.tree.map(np.asarray, bn))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    # the image tower's 8 and 12 a block, the text tower's 5 and 12 a block,
    # SIE, two classifiers, two BNNeck scales and cls_ctx
    assert len(named) == (8 + 2 * 12) + (5 + 2 * 12) + 6
    for name, p in named:
        # the token embedding feeds only the prompt buffers: no gradient
        a = to_np(torch.zeros_like(p) if p.grad is None else p.grad)
        b = to_np(want[name])
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel < 1e-4, (name, rel)
    model.zero_grad()


# ---------------------------------------------------------------------------
# the CLIP archive's text half


def _write_archive(path: Path):
    """A CLIP-shaped ``torch.save`` state dict at the test's widths: the
    visual tower on a 3×3 pretrained grid and the text tower, both random."""
    gen = torch.Generator().manual_seed(12)
    visual = tvit.VisionTransformer(h_resolution=3, w_resolution=3, width=128, layers=2,
                                    output_dim=64)
    visual.reset_parameters(gen)
    text = tte.TextTransformer(embed_dim=64, **TEXT)
    text.reset_parameters(gen)
    sd = {f"visual.{k}": v for k, v in visual.state_dict().items()}
    sd.update({k: v + 0.1 * torch.randn(v.shape, generator=gen) if "ln" in k else v
               for k, v in text.state_dict().items()})
    sd["logit_scale"] = torch.ones([])
    torch.save({k: v.half() for k, v in sd.items()}, path)
    return {k: v.half().float() for k, v in sd.items()}


def test_clip_text_import_matches_jax(pair, tmp_path):
    _, params, bn, tspec, _ = pair
    path = tmp_path / "ViT-B-16.pt"
    sd = _write_archive(path)
    model = tcr.ClipReID(tspec)
    load_clip_into_clipreid(model, str(path))
    # the text tower is the archive's text half, as JAX's importer reads it
    # (carried by the same mapping as the weights)
    jtext = jte.load_clip_text_params({k: v.numpy() for k, v in sd.items()}, layers=2)
    want = {k.removeprefix("text."): v for k, v in clipreid_state_dict_from_jax(
        jax.tree.map(np.asarray, dict(params, text=jtext)),
        jax.tree.map(np.asarray, bn)).items() if k.startswith("text.")}
    got = model.text.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
        assert torch.equal(v, sd[k]), k
    # the image tower is the archive's visual half, the pos embed resized
    for k, v in model.base.state_dict().items():
        src = sd[f"visual.{k}"]
        if k == "positional_embedding":
            src = tvit.resize_pos_embed(src, 4, 2)
        assert torch.equal(v, src), k
    # the prompt template re-embedded with the imported token embedding
    emb = sd["token_embedding.weight"][model.prompt_learner.tokenized]
    assert torch.equal(model.prompt_learner.token_prefix, emb[:5])
    assert torch.equal(model.prompt_learner.token_suffix, emb[9:])


def test_clip_text_import_refuses_a_fallback_tokenizer(pair, tmp_path, monkeypatch):
    _, _, _, tspec, _ = pair
    path = tmp_path / "ViT-B-16.pt"
    _write_archive(path)
    model = tcr.ClipReID(tspec)
    before = _state(model)
    monkeypatch.setattr(ttok, "resolve_bpe_path", lambda p=None: None)
    fallback = ttok.ClipTokenizer()
    with pytest.raises(ValueError, match="byte-fallback"):
        load_clip_into_clipreid(model, str(path), tokenizer=fallback)
    with pytest.raises(ValueError, match="byte-fallback"):
        load_clip_into_clipreid(model, str(path))        # the default resolution too
    with pytest.raises(ValueError, match="byte-fallback"):
        tte.load_clip_text_params({}, tokenizer=fallback)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(FileNotFoundError):
        load_clip_into_clipreid(model, str(tmp_path / "missing.pt"))

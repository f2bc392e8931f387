"""The closed-loop gallery stream of ``kinds/gallery.py`` on Signal's
T2T-ViT-t-14 tower: the same pool, loop, window, latency, traced
sub-windows and check, with three things of the tower's own.

* The weights are drawn over ``reference/t2t.param_shapes`` by
  ``inputs.make_weights``' rules (one normal draw on the device, each
  tensor's σ or constant by its name: LayerNorm scales 1 and shifts 0,
  biases N(0, 0.02), the classifiers N(0, 0.001), every other weight,
  the class token and the SIE table included, N(0, 1/(3·fan_in))), but
  for the position table, which is T2T-ViT's fixed sinusoid table, and
  the token transformers' q and k rows, drawn at σ = (4/(d·dim))^1/4 so
  that their logits spread with a standard deviation of 2
  (:data:`LOGIT_STD`). At the default σ they spread by 0.2 over 2,048
  keys, and the attention is a near-uniform mean that a fault in it
  hardly moves: at a toy size the head's scale (64^-1/2) in place of the
  input dim's read a feature gap of 0.005 there, and 0.07 here.
* The plain reference is ``reference/t2t.gallery_features``; and, as a
  second number, ``t2t_gap``: the largest relative L2 gap over tower rows
  between the port's float32 token map (``models/t2t.token_map``, the two
  token transformers' output) and ``reference/t2t.gallery_token_maps``',
  on the checked batches, the port's recomputed on the normalised
  images once the window is over. ``feature_gap`` cannot see the token
  attention's precision: its error passes into a bf16 projection and a
  bf16 body, whose own rounding fills that gap's band, so a token
  attention run in TF32 or bf16 would read as sound there.
* MFU's model FLOPs are ``t2t_yardstick.signal_flops``.

The traced window is ``kinds/gallery.traced_window``, called through this
module's name for it (so ``spanwindow.py`` can wrap it here).
"""

from __future__ import annotations

import random
import time
from typing import Dict

import numpy as np
import torch

from portbench import correct, harness, spec, t2t_yardstick
from portbench.harness import Completion, Pool, Run
from portbench.inputs import _constant, _std, make_pool
from portbench.kinds.gallery import traced_window
from portbench.reference import t2t
from portbench.reference.recipe import normalize

LOGIT_STD = 2.0


def make_weights(arch: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights for ``seed`` (the same seed gives the same
    tensors)."""
    shapes = t2t.param_shapes(arch)
    sizes = [int(np.prod(s)) if s else 1 for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(spec.subseed(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        t = flat[at:at + n].view(shape)
        at += n
        std = _std(name, shape, arch)
        if std is None:
            t.fill_(_constant(name))
        else:
            t.mul_(std)
        out[name] = t
    pos = out[t2t.TOWER + "pos_embed"]
    pos.copy_(t2t.sinusoid_table(pos.shape[1], pos.shape[2])[None])
    td = arch["token_dim"]
    for i in (1, 2):
        qkv = out[f"{t2t.T2T}attention{i}.attn.qkv.weight"]
        # logit = Σ_d q_d·k_d·dim^-1/2 over unit-variance LN outputs: its
        # variance is td·(dim·σ²)²/dim; the rows were drawn at (3·dim)^-1/2
        dim = qkv.shape[1]
        sigma = (LOGIT_STD ** 2 / (td * dim)) ** 0.25
        qkv[:2 * td].mul_(sigma * (3 * dim) ** 0.5)
    return out


def port_token_maps(model, hp: dict, imgs_u8, rows: int = 32) -> torch.Tensor:
    """The port's :func:`models.t2t.token_map` of a uint8 batch's tower rows,
    laid out as ``reference/t2t.gallery_token_maps`` lays out its own."""
    from signal_tpu_torch.models.t2t import token_map

    net = model.base.tokens_to_token
    with torch.no_grad():
        return torch.cat([token_map(net, normalize(imgs_u8[i:i + rows], hp["mean"], hp["std"])
                                    .flatten(0, 1)).flatten(1)
                          for i in range(0, imgs_u8.shape[0], rows)])


def run(run: Run) -> dict:
    import signal_tpu_torch.engine.eval as engine_eval
    from signal_tpu_torch.metrics import R1mAPEvaluator

    cell, dev, traffic = run.cell, run.device, run.cell.traffic
    arch = t2t.reference_arch(cell.config, train=False)
    hp = spec.recipe(cell.config)
    B = hp["batch_test"]
    pool = Pool(make_pool(arch, B, traffic["pool_batches"], run.seed, dev))
    cfg, model = harness.build_port(run, make_weights(arch, run.seed, dev))
    normalize = (cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)

    class Evaluator(R1mAPEvaluator):
        """The port's evaluator, noting when each batch's features are
        complete."""

        def __init__(self, completion=None):
            super().__init__(num_query=B, feat_norm=cfg.TEST.FEAT_NORM == "yes")
            self.completion = completion

        def update(self, feat, *args, **kw):
            if self.completion is not None:
                self.completion.mark()
            super().update(feat, *args, **kw)

    def extract(batches, evaluator):
        engine_eval.extract_features(model, batches, evaluator, device=dev, normalize=normalize)

    extract(pool.take(traffic["warmup_batches"]), Evaluator())
    run.sync()
    setup_peak = harness.peak_bytes(run)
    setup_s = time.perf_counter() - run.t_start

    start = pool.cursor
    ctx = values = None
    if not run.trace:
        issued, completion = [], Completion(run.cuda)
        ev = Evaluator(completion)
        t0 = time.perf_counter()
        extract(pool.take(until=t0 + run.seconds, issued=issued), ev)
        done = completion.close()
        run.sync()
        elapsed = time.perf_counter() - t0
        latency = [t - issued[k] for k, t in enumerate(done)]
        values = {"gallery_samples_per_s": len(done) * B / elapsed,
                  "gallery_batch_ms_p95": 1e3 * harness.nearest_rank(
                      latency, traffic["latency_percentile"]) if latency else float("nan"),
                  "setup_s": setup_s}
        attempted, failed = len(issued), len(issued) - len(done)
    else:
        ev, ctx = traced_window(run, pool, engine_eval, extract, Evaluator, arch, B)
        ctx.unit_flops = t2t_yardstick.signal_flops(arch, B)
        attempted, failed = len(ev.feats), 0
    device = harness.device_info(run, max(setup_peak, harness.peak_bytes(run)))

    # a sample of the batches the window issued, drawn from the seed
    pick = random.Random(spec.subseed(run.seed, "check"))
    by_pool = {}
    for k in range(len(ev.feats)):
        by_pool.setdefault((start + k) % len(pool.batches), k)
    chosen = sorted(pick.sample(sorted(by_pool), min(traffic["checked_batches"], len(by_pool))))
    prog = {i: ev.feats[by_pool[i]].clone() for i in chosen}
    images = {i: torch.from_numpy(pool.batches[i]["packed"]).to(dev) for i in chosen}
    maps = {i: port_token_maps(model, hp, images[i]) for i in chosen}
    del ev, model
    harness.free_device()
    weights = make_weights(arch, run.seed, dev)
    gaps, map_gaps = [], []
    for i in chosen:
        ref = t2t.gallery_features(weights, arch, hp, images[i],
                                   torch.from_numpy(pool.batches[i]["camids"]).to(dev))
        gaps.append(correct.feature_gap(prog[i], ref))
        map_gaps.append(correct.feature_gap(maps[i], t2t.gallery_token_maps(weights, arch, hp,
                                                                            images[i])))
    numbers = {"feature_gap": max(gaps) if gaps else float("inf"),
               "t2t_gap": max(map_gaps) if map_gaps else float("inf")}
    ok, checks = correct.verdict(numbers, spec.limits(cell.config, "gallery"))
    return harness.result(run, ok=ok, attempted=attempted, failed=failed, device=device,
                          checks=checks, values=values, ctx=ctx)

#!/usr/bin/env python3
"""How well-conditioned the tiny CPU parity comparisons of the other
backbones are (``tests/test_torch_backbones.py``, ``tests/test_torch_cnn.py``).

Runs on the CPU, JAX and the PyTorch port side by side on the tests' tiny
models and batch, and prints one JSON line:

* ``t2t_feature_spread``: the smallest pairwise squared distance between
  the CLS features of the batch's samples, against their squared norm, for
  the tiny T2T at its init std, with its kernels ×5, and the tiny ImageNet
  ViT: a spread near zero makes the BNNecks and the triplet after the
  tower ill-conditioned;
* ``jit_vs_eager``: JAX's own jitted train step against the same step
  eagerly (``jax.disable_jit``): the relative loss difference and the
  largest per-tensor relative L2 gradient difference, for the tiny T2T,
  ResNet (one bottleneck a stage) and osnet_x0_25, and the largest
  difference of the CNN trunks' train-mode outputs;
* ``port_input_move``: how far the port's own step gradients move when the
  input moves by one ulp (2^-23) and by 1e-6 relative (the largest
  per-tensor relative L2 change).

    env JAX_PLATFORMS=cpu python3 scripts/parity_conditioning.py   # about 10 minutes
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def grad_spread(a: dict, b: dict) -> float:
    from _torch_parity import to_np

    return max(rel_l2(to_np(a[n]), to_np(b[n])) for n in b
               if n in a and np.linalg.norm(to_np(b[n])) >= 1e-6)


def feature_spread(ttype: str, shrink: dict, kernel_scale: float = 1.0) -> dict:
    from _torch_parity import pair_from_config, train_batch
    from signal_tpu.models import signal_model as jsm

    _, _, jspec, params, bn, _ = pair_from_config(ttype, shrink)
    if kernel_scale != 1.0:
        params = dict(params, base=jax.tree_util.tree_map_with_path(
            lambda p, a: a * kernel_scale if "kernel" in jax.tree_util.keystr(p) else a,
            params["base"]))
    x, _, cams = train_batch(0)
    out, _ = jsm.forward_train(params, bn, jnp.asarray(x), jnp.asarray(cams), jspec)
    f = np.asarray(out["feats"][0])
    d2 = ((f[:, None] - f[None]) ** 2).sum(-1)
    return {"d2_min": float(d2[~np.eye(len(f), dtype=bool)].min()),
            "norm2": float((f ** 2).sum(-1).mean())}


def jit_vs_eager(ttype: str, shrink: dict) -> dict:
    from _torch_parity import one_train_step, pair_from_config

    jitted = one_train_step(*pair_from_config(ttype, shrink))
    with jax.disable_jit():
        eager = one_train_step(*pair_from_config(ttype, shrink))
    return {"loss_rel": abs(jitted["jloss"] - eager["jloss"]) / abs(eager["jloss"]),
            "grad_rel_l2_max": grad_spread(jitted["jgrads"], eager["jgrads"])}


def trunk_jit_vs_eager(backbone: str) -> float:
    from signal_tpu.models import osnet, resnet
    from _torch_parity import images, tiny_pair

    fields = dict(num_classes=5, camera_num=3, h=4, w=4, img_h=64, img_w=64, topk=3,
                  use_a=False, use_b=False)
    fields.update(dict(backbone="resnet", layers=1, feat_dim=2048, width=2048)
                  if backbone == "resnet" else dict(backbone="osnet", feat_dim=128, width=128))
    _, params, bn, _ = tiny_pair(base=fields)
    fwd = resnet.resnet50_forward if backbone == "resnet" else osnet.osnet_forward
    x = jnp.asarray(images(np.random.default_rng(0), 2, (64, 64)).reshape(6, 3, 64, 64))

    def run(p):
        return fwd(p, bn["base"], x, training=True, compute_dtype=jnp.float32)[0]

    return float(jnp.abs(jax.jit(run)(params["base"]) - run(params["base"])).max())


def port_input_move(ttype: str, shrink: dict) -> dict:
    from _torch_parity import pair_from_config, train_batch
    from signal_tpu_torch.losses import make_loss, total_train_loss
    from signal_tpu_torch.models import signal_model as tsm

    _, cfg, _, _, _, model = pair_from_config(ttype, shrink)
    x, pids, cams = (torch.from_numpy(a) for a in train_batch(0))
    noise = torch.from_numpy(np.random.default_rng(3).standard_normal(tuple(x.shape))
                             .astype(np.float32))
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def grads(v):
        model.load_state_dict(state)
        out = tsm.forward_train(model, v, cams)
        loss = total_train_loss(out, pids, make_loss(cfg, 5),
                                gram_weight=cfg.MODEL.Gram_Loss_weight,
                                pat_weight=cfg.MODEL.PAT_Loss_weight)
        params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        g = torch.autograd.grad(loss, [p for _, p in params], allow_unused=True)
        return {n: t.numpy() for (n, _), t in zip(params, g) if t is not None}

    g0 = grads(x)
    return {f"eps_{eps:g}": grad_spread(grads(x * (1 + eps * noise)), g0)
            for eps in (2.0 ** -23, 1e-6)}


def main() -> None:
    from signal_tpu.models import resnet as jresnet
    from signal_tpu_torch.models import resnet as tresnet

    for mod in (jresnet, tresnet):
        mod.RESNET_BLOCK_COUNTS[1] = (1, 1, 1, 1)
    t2t = dict(layers=2, width=96, feat_dim=96, topk=3, remat=True)
    cnns = {"resnet": ("resnet101", dict(layers=1, topk=3)),
            "osnet_x0_25": ("osnet_x0_25", dict(topk=3))}
    out = {
        "t2t_feature_spread": {
            "init": feature_spread("t2t_vit_t_14", t2t),
            "kernels_x5": feature_spread("t2t_vit_t_14", t2t, 5.0),
            "imagenet_vit": feature_spread("vit_base_patch16_224",
                                           dict(layers=2, width=96, feat_dim=96, num_heads=6,
                                                topk=3))},
        "jit_vs_eager": {"t2t": jit_vs_eager("t2t_vit_t_14", t2t),
                         **{k: jit_vs_eager(*v) for k, v in cnns.items()},
                         "trunk_train_max_abs": {b: trunk_jit_vs_eager(b)
                                                 for b in ("resnet", "osnet")}},
        "port_input_move": {k: port_input_move(*v) for k, v in cnns.items()},
        "host": {"torch": torch.__version__, "jax": jax.__version__},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()

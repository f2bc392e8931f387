"""Shared set-up of the PyTorch port's parity tests: one tiny Signal spec
built in both packages, with the JAX weights carried into the port by
``state_dict_from_jax``. Inputs come from numpy generators and cross
between the frameworks as numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

# 2-layer CLIP tower of width 128 (4 heads of 32) on a 64×32 image
# (a 4×2 patch grid, 9 tokens), SIM with TOPK 3
TINY = dict(num_classes=5, camera_num=3, width=128, layers=2, num_heads=4,
            feat_dim=64, h=4, w=2, topk=3)
IMG_HW = (64, 32)

# the train slice's tiny spec: DAS needs at least a 4×4 grid, so a 64×64
# image (16 patch tokens); SIM TOPK 3, GAM + LAM on
TRAIN_TINY = dict(TINY, h=4, w=4, use_a=True, use_b=True, stage="together_CLS_Patch")
TRAIN_IMG_HW = (64, 64)


def tiny_pair(compute_dtype: str = "float32", use_flash: bool = True, seed: int = 0,
              base: dict = TINY, remat: bool = False, **kw):
    """→ (jax_spec, jax_params, jax_bn_state, port Signal loaded strictly
    with the same weights, in eval mode). ``base``: TINY (eval tests) or
    TRAIN_TINY."""
    from signal_tpu.models import signal_model as jsm
    from signal_tpu_torch.models import signal_model as tsm
    from signal_tpu_torch.models.convert import state_dict_from_jax

    fields = {**base, **kw, "compute_dtype": compute_dtype, "use_flash": use_flash,
              "remat": remat}
    jspec = jsm.ModelSpec(**fields)
    tspec = tsm.ModelSpec(**fields)
    params, bn = jsm.init_signal_params(jax.random.PRNGKey(seed), jspec)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, bn), tspec)
    model = tsm.Signal(tspec)
    model.load_state_dict(sd, strict=True)
    return jspec, params, bn, model.eval()


def images(rng: np.random.Generator, batch: int, hw=IMG_HW) -> np.ndarray:
    """Normalized packed images [B, 3 modal, 3 ch, H, W] in [-1, 1]."""
    u8 = rng.integers(0, 256, (batch, 3, 3, *hw))
    return (u8 / 127.5 - 1.0).astype(np.float32)


def tiny_train_cfg(mod, tmp_path=None, *opts):
    """The synthetic config at the train tiny size, in the config module
    ``mod`` of either package: 64×64 images, batches of 8 (4 ids × 2),
    one thread, Adam; ``opts`` are more KEY VALUE overrides."""
    base = ["INPUT.SIZE_TRAIN", "[64, 64]", "INPUT.SIZE_TEST", "[64, 64]",
            "SOLVER.IMS_PER_BATCH", "8", "DATALOADER.NUM_INSTANCE", "2",
            "TEST.IMS_PER_BATCH", "8", "DATALOADER.NUM_WORKERS", "1", "MODEL.TOPK", "3"]
    if tmp_path is not None:
        base += ["OUTPUT_DIR", str(tmp_path)]
    return mod.load_config("configs/synthetic/smoke.yml", base + list(opts))


def to_np(x) -> np.ndarray:
    """JAX array or torch tensor → float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))

"""Visualization & analysis tools (port of `signal_tpu/vis.py`).

Equivalents of the reference's research tooling (maxingan2412/Signal):

* token-mask overlays (`zablation/token_visual.py`) — SIM's selection
  masks are returned by ``sim_forward``; here they render to heatmap
  grids;
* input-saliency maps (`zablation/CAM.py`, `visualize/GradCAM.py`) — via
  ``torch.autograd.grad`` of the matching score w.r.t. the input images
  (the JAX package takes ``jax.grad``; no forward hooks either way);
* LAM offset-field visualization (`zablation/offestvisual.py`), through
  the port's own ``models/align.das_sample_positions``;
* ranked-list grids, t-SNE scatter and cosine-similarity KDE
  (`utils/metrics.py:303-490`) — written to CALLER-CHOSEN paths.

The array functions are numpy; plotting imports matplotlib lazily and is
optional (a render returns None or [] without it), so nothing on the
serving or training path needs it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


# --------------------------------------------------------------------------
# Token-mask overlays
# --------------------------------------------------------------------------

def masks_to_grids(masks: Dict[str, np.ndarray], h: int, w: int) -> Dict[str, np.ndarray]:
    """{'RGB': [B, L], ...} → {'RGB': [B, h, w]} binary grids."""
    return {k: np.asarray(v).reshape(-1, h, w) for k, v in masks.items()}


def overlay_mask(image_chw: np.ndarray, mask_hw: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Upsample a patch mask onto the image; masked-out patches dimmed.
    image [3, H, W] in [0,1]-ish; returns [H, W, 3] uint8."""
    img = np.asarray(image_chw).transpose(1, 2, 0)
    img = (img - img.min()) / max(img.max() - img.min(), 1e-6)
    H, W = img.shape[:2]
    gh, gw = mask_hw.shape
    # ceil factors so non-divisible image/grid pairs (overlap strides)
    # still cover the image, then crop
    up = np.kron(mask_hw, np.ones((-(-H // gh), -(-W // gw))))
    up = up[:H, :W, None]
    out = img * (alpha + (1 - alpha) * up)
    return (255 * out).clip(0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# Saliency (GradCAM-style, functional)
# --------------------------------------------------------------------------

def input_saliency(forward_fn, imgs: Dict, target_fn=None) -> Dict[str, np.ndarray]:
    """Per-modality |d score / d pixel| maps [B, H, W] (max over channels).

    ``forward_fn(imgs) -> feats [B, D]`` on a {modality: [B, 3, H, W]}
    dict of tensors; ``target_fn(feats) -> scalar`` (default: feature-norm
    sum, a class-agnostic saliency)."""
    if target_fn is None:
        target_fn = lambda f: f.norm(dim=-1).sum()  # noqa: E731

    leaves = {k: torch.as_tensor(v).detach().clone().requires_grad_(True)
              for k, v in imgs.items()}
    with torch.enable_grad():
        grads = torch.autograd.grad(target_fn(forward_fn(leaves)), list(leaves.values()))
    return {k: g.detach().abs().amax(dim=1).cpu().numpy() for k, g in zip(leaves, grads)}


def token_grad_cam(patches_fn, imgs: Dict, target_fn=None) -> Dict[str, np.ndarray]:
    """Grad-CAM over the patch-token grid (`zablation/CAM.py` /
    `visualize/GradCAM.py` in the reference, which hook conv/SIM
    activations; here the activations are an explicit function's output).

    ``patches_fn(imgs) -> {'RGB': [B, L, D], ...}`` patch activations at
    the chosen layer; ``target_fn({mod: feats}) -> scalar`` score
    (default: summed token norms). Returns per-modality [B, L] maps:
    ReLU(Σ_d w_d · A_d) with w = gradient mean-pooled over tokens —
    upsample onto the image with ``overlay_mask``/``masks_to_grids``."""
    if target_fn is None:
        target_fn = lambda a: sum(f.norm(dim=-1).sum() for f in a.values())  # noqa: E731

    with torch.no_grad():
        acts = {k: torch.as_tensor(v) for k, v in patches_fn(imgs).items()}
    leaves = {k: a.detach().clone().requires_grad_(True) for k, a in acts.items()}
    with torch.enable_grad():
        grads = torch.autograd.grad(target_fn(leaves), list(leaves.values()))
    out = {}
    for k, g in zip(leaves, grads):
        a, g = acts[k].float().cpu().numpy(), g.float().cpu().numpy()   # [B, L, D]
        w = g.mean(axis=1, keepdims=True)                            # [B, 1, D]
        cam = np.maximum((a * w).sum(-1), 0.0)                       # [B, L]
        denom = cam.max(axis=1, keepdims=True)
        out[k] = cam / np.where(denom > 0, denom, 1.0)
    return out


# --------------------------------------------------------------------------
# LAM offset fields
# --------------------------------------------------------------------------

def das_offset_field(das, patches_grid) -> np.ndarray:
    """[B, C, H, W] grid → sampled positions [B, H/4, W/4, 2] (x, y) in
    normalized coords — the arrows of `zablation/offestvisual.py`. ``das``
    is one of ``AlignM``'s DAS modules; the port's DAS has the reference's
    stride 4 and offset range factor 2. Thin wrapper over the model's own
    offset computation, so the plot depicts exactly what ``das_forward``
    samples."""
    from signal_tpu_torch.models.align import das_sample_positions

    x = torch.as_tensor(patches_grid, dtype=torch.float32)
    with torch.no_grad():
        pos = das_sample_positions(das, x)
    return pos.flip(-1).cpu().numpy()  # (x, y)


# --------------------------------------------------------------------------
# Retrieval analysis artifacts (optional matplotlib)
# --------------------------------------------------------------------------

def save_ranked_list(distmat: np.ndarray, query_paths: Sequence[str],
                     gallery_paths: Sequence[str], save_dir: str,
                     topk: int = 10, num_queries: int = 10) -> List[List[str]]:
    """Write per-query top-k gallery file lists (and return them)."""
    os.makedirs(save_dir, exist_ok=True)
    order = np.argsort(distmat, axis=1)
    out = []
    with open(os.path.join(save_dir, "ranked_lists.txt"), "w") as f:
        for qi in range(min(num_queries, distmat.shape[0])):
            row = [gallery_paths[g] for g in order[qi, :topk]]
            out.append(row)
            f.write(f"{query_paths[qi]}: " + " ".join(row) + "\n")
    return out


def render_ranked_list_grids(distmat: np.ndarray, query_records,
                             gallery_records, save_dir: str, topk: int = 10,
                             num_queries: int = 10,
                             scene_filter: bool = False) -> List[str]:
    """Per-query 3-modality image grids of the top-k gallery matches, with
    green (same pid) / red (different pid) borders — the reference's
    `visualize_ranked_list_results` + `plot_images`
    (`utils/metrics.py:303-383`, `utils/ranklist_vehicle.py`).

    ``*_records``: dataset record tuples (paths, pid, camid, trackid) —
    the three modality crops are loaded exactly as the data pipeline loads
    them (packed single jpg or 3-file tuple, `data/datasets/bases.py:18-22`).
    Mirrors the reference's different-camera filter on the ranking;
    ``scene_filter`` switches to the MSVR310 variant's different-SCENE
    filter (`utils/ranklist_vehicle.py:285` uses sceneid, not camid,
    when ranking vehicle galleries).
    Returns the written file paths ([] if matplotlib is unavailable).
    """
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.patches as mpatches
        import matplotlib.pyplot as plt
    except ImportError:
        return []
    from signal_tpu_torch.data.loader import read_modalities

    os.makedirs(save_dir, exist_ok=True)
    g_pids = np.asarray([r[1] for r in gallery_records])
    g_camids = np.asarray([r[2] for r in gallery_records])
    g_scenes = np.asarray([r[3] for r in gallery_records])
    modalities = ("RGB", "NIR", "TIR")
    saved = []
    for qi in range(min(num_queries, distmat.shape[0])):
        q_paths, q_pid, q_camid, q_scene = query_records[qi]
        order = np.argsort(distmat[qi])
        if scene_filter:
            order = [g for g in order if g_scenes[g] != q_scene][:topk]
        else:
            order = [g for g in order if g_camids[g] != q_camid][:topk]
        q_imgs = read_modalities(q_paths)
        if len(q_imgs) == 1:  # synthetic single-modality fallback
            q_imgs = q_imgs * 3

        fig, axs = plt.subplots(3, len(order) + 1,
                                figsize=(2 * (len(order) + 1), 8),
                                squeeze=False)
        for j, (img, mod) in enumerate(zip(q_imgs, modalities)):
            axs[j][0].imshow(np.asarray(img))
            axs[j][0].set_title(f"Query {mod}", fontsize=9)
            axs[j][0].axis("off")
        for rank, g in enumerate(order):
            g_imgs = read_modalities(gallery_records[g][0])
            if len(g_imgs) == 1:
                g_imgs = g_imgs * 3
            color = "green" if g_pids[g] == q_pid else "red"
            for j, img in enumerate(g_imgs):
                arr = np.asarray(img)
                ax = axs[j][rank + 1]
                ax.imshow(arr)
                ax.axis("off")
                ax.add_patch(mpatches.Rectangle(
                    (0, 0), arr.shape[1], arr.shape[0], linewidth=4,
                    edgecolor=color, facecolor="none"))
                ax.set_title(f"Rank {rank + 1}", fontsize=9)
        fig.tight_layout()
        path = os.path.join(save_dir, f"query_{qi}_results.png")
        fig.savefig(path)
        plt.close(fig)
        saved.append(path)
    return saved


def render_fusion_similarity_kde(pre_src: np.ndarray, pre_tgt: np.ndarray,
                                 post_src: np.ndarray, post_tgt: np.ndarray,
                                 pattern: str, save_path: str) -> Optional[str]:
    """Cross-modal token-similarity KDE before vs after fusion — the
    reference's `visualize_similarity` (`utils/ranklist_vehicle.py:697-761`):
    per-token cosine similarity between a source and target modality's
    patch tokens, as two density curves. ``pattern`` ∈
    {'r2t','r2n','n2t','n2r','t2r','t2n'} labels the modality pair.
    Returns the written path (None if matplotlib is unavailable)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    def cos_sim(a, b):
        a = np.asarray(a, np.float32).reshape(-1, a.shape[-1])
        b = np.asarray(b, np.float32).reshape(-1, b.shape[-1])
        num = np.sum(a * b, axis=-1)
        den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12
        return num / den

    def kde(xs, grid):
        # Gaussian KDE, Scott's bandwidth (no scipy/seaborn dependency)
        xs = np.asarray(xs, np.float64)
        bw = max(xs.std() * xs.size ** (-1 / 5), 1e-3)
        d = (grid[:, None] - xs[None, :]) / bw
        return np.exp(-0.5 * d * d).sum(1) / (xs.size * bw * np.sqrt(2 * np.pi))

    sims_pre = cos_sim(pre_src, pre_tgt)
    sims_post = cos_sim(post_src, post_tgt)
    grid = np.linspace(-1.05, 1.05, 256)
    names = {"r2t": "R and T", "r2n": "R and N", "n2t": "N and T",
             "n2r": "N and R", "t2r": "T and R", "t2n": "T and N"}
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.fill_between(grid, kde(sims_pre, grid), alpha=0.4, color="b",
                    label="Before fusion")
    ax.fill_between(grid, kde(sims_post, grid), alpha=0.4, color="g",
                    label="After fusion")
    ax.set_title(f"Similarity Distribution between "
                 f"{names.get(pattern, pattern)}")
    ax.set_xlabel("Cosine Similarity")
    ax.set_ylabel("Density")
    ax.legend(loc="upper right")
    fig.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path)
    plt.close(fig)
    return save_path


def save_tsne_plot(feats: np.ndarray, labels: Sequence[int], save_path: str,
                   draw_labels: Optional[Sequence[int]] = None):
    """t-SNE scatter of selected identities (`metrics.py:387-411`)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn import manifold
    except ImportError:
        return None
    labels = np.asarray(labels)
    if draw_labels is not None:
        sel = np.isin(labels, draw_labels)
        feats, labels = feats[sel], labels[sel]
    emb = manifold.TSNE(n_components=2, init="pca",
                        random_state=0).fit_transform(np.asarray(feats))
    fig, ax = plt.subplots(figsize=(6, 6))
    for lab in np.unique(labels):
        pts = emb[labels == lab]
        ax.scatter(pts[:, 0], pts[:, 1], s=8, label=str(lab))
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return save_path


def save_similarity_kde(qf: np.ndarray, q_pids: Sequence[int], save_path: str):
    """Pos/neg cosine-similarity distribution + overlap area
    (`metrics.py:414-490`). Returns the overlap estimate."""
    q = np.asarray(qf)
    q = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-12)
    sim = q @ q.T
    pids = np.asarray(q_pids)
    same = pids[:, None] == pids[None, :]
    iu = np.triu_indices_from(sim, k=1)
    pos = sim[iu][same[iu]]
    neg = sim[iu][~same[iu]]
    # histogram overlap (robust, no scipy needed)
    bins = np.linspace(-1, 1, 101)
    hp, _ = np.histogram(pos, bins=bins, density=True)
    hn, _ = np.histogram(neg, bins=bins, density=True)
    overlap = np.minimum(hp, hn).sum() * (bins[1] - bins[0])
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.hist(pos, bins=50, alpha=0.5, density=True, label="positive")
        ax.hist(neg, bins=50, alpha=0.5, density=True, label="negative")
        ax.legend()
        ax.set_title(f"cosine similarity, overlap={overlap:.3f}")
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    except ImportError:
        pass
    return overlap

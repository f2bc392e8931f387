"""The T2T cell's frozen arithmetic: the model FLOPs of Signal on the
T2T-ViT tower, and the token attention operator's launches in a trace
with their operations and bytes.

Nothing here imports the port. :func:`signal_flops` is a copy of the
port's ``utils/flops.signal_analytic_flops`` at backbone ``t2t`` (its
``_t2t_stage_flops`` for the soft-split stages instead of a patch
convolution, no output projection, SIM), as it stood when the cell was
added; ``tests/test_portbench_t2t.py`` holds the two equal at the cell's
configuration.

The token attention is counted by what it computes, whatever implements
it: one head, q, k, v [N, L, d] in float32, QKᵀ and A·V (4·N·Lq·Lk·d
operations), q, k and v read once and the output written once.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from portbench.readers import Readings
from portbench.trace import HostOp

TOKEN_ATTENTION = "signal_tpu_torch::token_attention"


def signal_flops(arch: dict, batch: int, *, train: bool = False) -> float:
    """Model FLOPs (2·MACs of the products) of one Signal forward on the
    T2T tower over ``batch`` triplets, or of one train step (3 × the
    forward). ``arch``: ``reference.t2t.reference_arch``."""
    W, D, depth, td = arch["width"], arch["feat_dim"], arch["layers"], arch["token_dim"]
    H, Wd = arch["img_h"], arch["img_w"]

    def token_tf(L, dim):
        return (2.0 * L * dim * 3 * td        # qkv
                + 4.0 * L * L * td            # QKᵀ + A·V (one head)
                + 2.0 * L * td * td           # proj
                + 4.0 * L * td * td)          # MLP fc1 + fc2 (hidden 64)

    L0, L1, L2 = (H // 4) * (Wd // 4), (H // 8) * (Wd // 8), (H // 16) * (Wd // 16)
    stages = token_tf(L0, 3 * 49) + token_tf(L1, td * 9) + 2.0 * L2 * (td * 9) * W
    L = arch["h"] * arch["w"]
    T = L + 1
    per_layer = (8.0 + 4.0 * arch["mlp_ratio"]) * W * W * T
    attn = 4.0 * T * T * W
    fwd = 3 * batch * (stages + depth * (per_layer + attn))
    if arch["use_a"]:
        fwd += batch * (
            2.0 * D * D * (3 + 3 * L)
            + 2.0 * 3 * (3 * L) * D
            + 2.0 * D * 3 * D * (3 + 3 * L)
            + 4.0 * 3 * (3 * L) * D
            + 2.0 * D * D * 3
            + 2.0 * 3 * (2 * D * 2 * D))
    return fwd * 3.0 if train else fwd


def token_attention_cost(q_shape: Sequence[int], k_shape: Sequence[int]
                         ) -> Tuple[float, float]:
    """(operations, bytes) one call needs: QKᵀ and A·V, 2·2·N·Lq·Lk·d;
    float32 q, k, v read once and the output written once."""
    N, Lq, d = q_shape
    Lk = k_shape[1]
    return 4.0 * N * Lq * Lk * d, 4.0 * d * N * (2 * Lq + 2 * Lk)


def token_attention_launches(ctx: Readings) -> List[Tuple[HostOp, float]]:
    """Each call of the operator in the profiled window: (its host event,
    µs of the device operations the profiler links to it)."""
    calls = {}
    for d in ctx.window_ops():
        op = d.under((TOKEN_ATTENTION,))
        if op is not None:
            calls.setdefault(id(op), [op, 0.0])[1] += d.dur
    return [(op, us) for op, us in calls.values()]

"""The benchmark's frozen arithmetic: the card's published peaks, the model
FLOPs of a Signal step, the operations and bytes of an attention launch,
the union of device intervals, and the table that sorts kernels by kind.

Nothing here imports the port: a program change cannot move the
yardstick. The FLOP count is a copy of the port's
``utils/flops.signal_analytic_flops`` for the CLIP tower with SIM, as it
stood when the benchmark was written (``tests/test_portbench_yardstick.py``
holds the two equal at both configurations); the kind table is a copy of
``scripts/profile_torch_train.py``'s ``KINDS``.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

# NVIDIA's data sheets, dense rates: (bytes/s of device memory, bf16
# FLOP/s on the tensor cores). Matched by substring of the device name,
# in this order (the PCIe part first: "H100" matches both).
PEAKS = (
    ("H100 PCIe", 2.0e12, 756e12),
    ("H100", 3.35e12, 989e12),
    ("H200", 4.8e12, 989e12),
)


def peaks(device_name: str) -> Tuple[float, float]:
    """(bytes/s, bf16 FLOP/s) of the named card; raises for a card the
    table does not hold (a share of an unknown peak would be a guess)."""
    for key, bw, flops in PEAKS:
        if key in device_name:
            return bw, flops
    raise ValueError(f"no published peaks for {device_name!r}")


def signal_flops(arch: dict, batch: int, *, train: bool) -> float:
    """Model FLOPs (2·MACs of the products and the patch convolution) of
    one Signal forward over ``batch`` triplets, or of one train step
    (3 × the forward; remat's replay is not model work). ``arch``: width,
    layers, feat_dim, patch, h, w, use_a (see ``spec.reference_arch``)."""
    W, D, depth = arch["width"], arch["feat_dim"], arch["layers"]
    L = arch["h"] * arch["w"]
    T = L + 1
    R = 3 * batch
    conv = 2.0 * (arch["patch"] ** 2 * 3) * W * L
    per_layer = (8.0 + 4.0 * arch["mlp_ratio"]) * W * W * T
    attn = 4.0 * T * T * W
    proj = 2.0 * W * D * T
    fwd = R * (conv + depth * (per_layer + attn) + proj)
    if arch["use_a"]:
        fwd += batch * (
            2.0 * D * D * (3 + 3 * L)
            + 2.0 * 3 * (3 * L) * D
            + 2.0 * D * 3 * D * (3 + 3 * L)
            + 4.0 * 3 * (3 * L) * D
            + 2.0 * D * D * 3
            + 2.0 * 3 * (2 * D * 2 * D))
    return fwd * 3.0 if train else fwd


def attention_fwd_cost(q_shape: Sequence[int], k_shape: Sequence[int],
                       itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) one forward launch needs: QKᵀ and PV, 2·2·B·Lq·Lk·D;
    q, k, v read once and o written once."""
    B, Lq, D = q_shape
    Lk = k_shape[1]
    ops = 4.0 * B * Lq * Lk * D
    nbytes = float(itemsize) * D * B * (2 * Lq + 2 * Lk)
    return ops, nbytes


def attention_bwd_cost(q_shape: Sequence[int], k_shape: Sequence[int],
                       itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) one backward launch needs: the four gradient
    products (dV, dP, dQ, dK), 2·4·B·Lq·Lk·D (the recompute of S is the
    kernel's choice, not counted); q, k, v and the output gradient read
    once, dq, dk, dv written once."""
    B, Lq, D = q_shape
    Lk = k_shape[1]
    ops = 8.0 * B * Lq * Lk * D
    nbytes = float(itemsize) * D * B * (3 * Lq + 4 * Lk)
    return ops, nbytes


def least_seconds(ops: float, nbytes: float, bw: float, flops: float) -> float:
    """The roofline: the larger of the operations at peak and the bytes at
    peak bandwidth."""
    return max(ops / flops, nbytes / bw)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (a device busy with
    two operations at once is busy once)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], start: float, end: float
              ) -> List[Tuple[float, float]]:
    """The [start, end) gaps of the window in which no interval runs."""
    gaps, cursor = [], start
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, end)))
        cursor = max(cursor, e)
        if cursor >= end:
            break
    if cursor < end:
        gaps.append((cursor, end))
    return [(s, e) for s, e in gaps if e > s]


# kernel-name substrings → kind, first match wins
KINDS = (
    ("attention_fwd", "attention forward"),
    ("attention_bwd", "attention backward"),
    ("rows_kernel", "attention backward"),
    ("cols_kernel", "attention backward"),
    ("gemm", "GEMM"), ("nvjet", "GEMM"), ("xmma", "GEMM"), ("cutlass", "GEMM"),
    ("conv", "convolution"), ("wgrad", "convolution"), ("dgrad", "convolution"),
    ("layer_norm", "LayerNorm"), ("LayerNorm", "LayerNorm"),
    ("sort", "sort / top-k"), ("topk", "sort / top-k"), ("scatter", "sort / top-k"),
    ("softmax", "softmax"),
    ("multi_tensor_apply", "optimizer"), ("adam", "optimizer"),
    ("reduce", "reduction"),
    ("copy", "copy / cast"), ("Memcpy", "copy / cast"), ("Memset", "copy / cast"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
)

MEMORY_PASS_KINDS = ("elementwise", "copy / cast")


def kind_of(name: str) -> str:
    for key, kind in KINDS:
        if key in name:
            return kind
    return "other"

"""The comparison that decides ``correct``: the port's readings against the
plain reference's, each number against its limit from the configuration
file (``limits.<traffic kind>``).

Train: ``loss_gap``, the largest relative gap of a checked step's loss;
``grad_gap``, the worst leaf's gap between the norms of the first step's
gradient as Adam takes it, measured against the reference's norm of that
leaf or of the median leaf, whichever is larger; ``update_gap``, the
relative gap between the median leaf's norm of the parameters' change
over the checked steps, the port's against the reference's. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by round-off alone and are left out of ``update_gap``.

The change is taken at the median leaf and not at the worst one: LAM's
offset branches (the DAS biases) have gradients a few thousandths of the
median leaf's that bilinear sampling makes discontinuous in the sample
positions, so on some seeds their Adam steps keep their signs on one side
and flip on the other, and the worst leaf's gap read 0.04-0.14 on most
seeds but 5.6 on one, for the port and a planted fault alike.

Gallery: ``feature_gap``, the largest relative L2 gap of a checked row's
features.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

import torch

MOVED = 1e-3     # a leaf's reference gradient under this × the median leaf's: not compared


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The worst leaf's gap. A leaf the program has no reading of reads as
    0; a NaN reading wins."""
    med = statistics.median(ref.values())
    worst = 0.0
    for name, r in ref.items():
        gap = abs(prog.get(name, 0.0) - r) / max(r, med)
        if not gap <= worst:
            worst = gap
    return worst


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    loss_gap = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
                   for p, r in zip(prog["losses"], ref["losses"]))
    med = statistics.median(ref["grad"].values())
    moved = [n for n, g in ref["grad"].items() if g >= MOVED * med]
    p_med = statistics.median(prog["change"].get(n, 0.0) for n in moved)
    r_med = statistics.median(ref["change"][n] for n in moved)
    return {"loss_gap": loss_gap, "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
            "update_gap": abs(p_med - r_med) / r_med}


def feature_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest relative L2 gap over rows."""
    gap = torch.linalg.vector_norm(prog.float() - ref.float(), dim=1) / \
        torch.linalg.vector_norm(ref.float(), dim=1)
    return float(gap.max()) if bool(torch.isfinite(gap).all()) else math.inf


def verdict(numbers: Dict[str, float], limits: Optional[Dict[str, float]]):
    """(correct, {name: {value, limit}}). A number without a limit, or not
    finite, fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = (limits or {}).get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and math.isfinite(value) and value <= limit
    return ok, checks

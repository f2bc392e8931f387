#!/usr/bin/env python3
"""Device time of T2T's token attention, forward and backward, on one
NVIDIA GPU: the operator the port runs against the candidates a kernel
behind it would be measured against.

    python3 scripts/time_token_attention_torch.py [--rows 384] [--iters 5]

At the gallery batch's shapes (B 128 triplets: 384 rows of one head of 64,
float32) of both token transformers, [rows, 2048, 64] at scale 147^-1/2
and [rows, 512, 64] at 576^-1/2, it times by CUDA events over ``--iters``
calls after a warm-up:

* ``eager``: ``torch.ops.signal_tpu_torch.token_attention``, the eager
  fp32 core with TF32 off (its backward recomputes the probabilities);
* ``port_fp32_kernel``: the port's fp32 attention kernels at one head
  (``ops/flash_attention.attention_fwd_cuda`` / ``attention_bwd_cuda``:
  the CUDA-core forward, the 3xTF32 backward), q pre-scaled by
  (dim/64)^-1/2 so that the kernels' 64^-1/2 makes the input dim's scale;
* ``sdpa``: ``torch.nn.functional.scaled_dot_product_attention`` in fp32
  at that scale (whichever backend PyTorch picks for it).

The backward is timed as forward + backward less the forward. Each
candidate's output is held to the eager one (max abs error printed). With
the operations (4·rows·L²·64 forward, twice that backward) at the
fp32-accurate tensor-core rate (495/3 TFLOP/s on an H100 SXM) and the
bytes (q, k, v, o; backward q, k, v, dO read, dq, dk, dv written, fp32)
at 3.35 TB/s, each time's bound is printed. Prints one JSON object last
and writes it to ``chiprun_out/time_token_attention_torch.json``. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FP32_TC = 495e12 / 3      # H100 SXM: TF32 dense 495 TFLOP/s; 3xTF32 takes three
BW = 3.35e12              # H100 SXM HBM3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=384)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_token_attention_torch: needs a CUDA card", file=sys.stderr)
        return 2
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda
    from signal_tpu_torch.ops.token_attention import token_attention

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    gen = torch.Generator(device=dev).manual_seed(0)

    def timed(fn, n):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    out = {"card": card.strip(), "rows": args.rows, "shapes": {}}
    for L, dim in ((2048, 147), (512, 576)):
        s = dim ** -0.5
        q, k, v, g = (torch.randn(args.rows, L, 64, device=dev, generator=gen)
                      for _ in range(4))
        # logits spread with a standard deviation of about 2, as in the cell
        q.mul_(2.0 / (64 ** 0.5 * s))
        ref = token_attention(q, k, v, s)

        def eager_fwd():
            return token_attention(q, k, v, s)

        def eager_both():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            torch.autograd.grad(token_attention(qq, kk, vv, s), (qq, kk, vv), g)

        qs = (q * (dim / 64) ** -0.5).contiguous()

        def port_fwd():
            return attention_fwd_cuda(qs, k, v, 1)

        def port_both():
            o = attention_fwd_cuda(qs, k, v, 1)
            attention_bwd_cuda(qs, k, v, g, 1)
            return o

        q4, k4, v4, g4 = (t[:, None] for t in (q, k, v, g))

        def sdpa_fwd():
            return F.scaled_dot_product_attention(q4, k4, v4, scale=s)[:, 0]

        def sdpa_both():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q4, k4, v4))
            o = F.scaled_dot_product_attention(qq, kk, vv, scale=s)
            torch.autograd.grad(o, (qq, kk, vv), g4)

        fwd_ops = 4.0 * args.rows * L * L * 64
        fwd_bytes = 4.0 * 64 * args.rows * 4 * L
        bwd_bytes = 4.0 * 64 * args.rows * 7 * L
        row = {"scale": s, "bound_fwd_ms": 1e3 * max(fwd_ops / FP32_TC, fwd_bytes / BW),
               "bound_bwd_ms": 1e3 * max(2 * fwd_ops / FP32_TC, bwd_bytes / BW)}
        with torch.no_grad():
            for name, f, b in (("eager", eager_fwd, eager_both), ("port_fp32_kernel", port_fwd,
                                                                   port_both),
                               ("sdpa", sdpa_fwd, sdpa_both)):
                err = (f() - ref).abs().max().item()
                torch.cuda.reset_peak_memory_stats()
                fwd_ms = timed(f, args.iters)
                with torch.enable_grad():
                    both_ms = timed(b, args.iters)
                row[name] = {"fwd_ms": fwd_ms, "bwd_ms": both_ms - fwd_ms,
                             "fwd_bwd_ms": both_ms, "max_abs_err_vs_eager": err,
                             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
                torch.cuda.empty_cache()
        out["shapes"][f"[{args.rows}, {L}, 64]"] = row
        print(json.dumps({f"[{args.rows}, {L}, 64]": row}), flush=True)
        del q, k, v, g, qs, q4, k4, v4, g4, ref
        torch.cuda.empty_cache()
    dest = REPO / "chiprun_out" / "time_token_attention_torch.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

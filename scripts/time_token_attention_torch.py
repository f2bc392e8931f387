#!/usr/bin/env python3
"""Device time of T2T's token attention, forward and backward, on one
NVIDIA GPU: the operator as the port runs it against the eager core it
replaced and PyTorch's own.

    python3 scripts/time_token_attention_torch.py [--rows 384] [--iters 5]

At the gallery batch's shapes (B 128 triplets: 384 rows of one head of 64,
float32) of both token transformers, [rows, 2048, 64] at scale 147^-1/2
and [rows, 512, 64] at 576^-1/2, with q, k and v the ``.chunk(3, -1)``
views of a [rows, L, 192] qkv product as ``models/t2t.token_transformer``
hands them over, it times by CUDA events over ``--iters`` calls after a
warm-up:

* ``kernel``: ``torch.ops.signal_tpu_torch.token_attention`` as it runs on
  the card, its forward ``csrc/token_attention.cu`` (3xTF32 on the tensor
  cores, the views as they lie), its backward the operator's (the
  probabilities recomputed eagerly);
* ``eager``: the eager fp32 core (``ops/token_attention.eager_core``, TF32
  off), the operator's forward until the kernel; its backward ATen's
  autograd of that expression, which keeps the probabilities;
* ``sdpa``: ``torch.nn.functional.scaled_dot_product_attention`` in fp32
  at that scale (whichever backend PyTorch picks for it).

The backward is timed as forward + backward less the forward. Each
candidate's output is held to the eager one (max abs error) and to a
float64 eager core on the first 16 rows (the largest relative L2 gap of a
row). With the operations (4·rows·L²·64 forward, twice that backward) at
the fp32-accurate tensor-core rate (495/3 TFLOP/s on an H100 SXM) and the
bytes (q, k, v, o; backward q, k, v, dO read, dq, dk, dv written, fp32)
at 3.35 TB/s, each time's bound is printed, with the forward's TFLOP/s
(the kernel's registers and spill bytes are ``chip_smoke.py``'s phase 2).
Prints one JSON object last and writes it to
``chiprun_out/time_token_attention_torch.json``. Needs a CUDA card.
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
    from signal_tpu_torch.ops.token_attention import eager_core, token_attention

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
        qkv = torch.randn(args.rows, L, 192, device=dev, generator=gen)
        g = torch.randn(args.rows, L, 64, device=dev, generator=gen)
        # logits spread with a standard deviation of about 2, as in the cell
        qkv[..., :64] *= 2.0 / (64 ** 0.5 * s)
        q, k, v = qkv.chunk(3, dim=-1)
        ref = eager_core(q, k, v, s)
        ref64 = eager_core(*(t[:16].double() for t in (q, k, v)), s)

        def kernel_fwd():
            return token_attention(q, k, v, s)

        def kernel_both():
            x = qkv.detach().requires_grad_()
            torch.autograd.grad(token_attention(*x.chunk(3, dim=-1), s), x, g)

        def eager_fwd():
            return eager_core(q, k, v, s)

        def eager_both():
            x = qkv.detach().requires_grad_()
            torch.autograd.grad(eager_core(*x.chunk(3, dim=-1), s), x, g)

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
            for name, f, b in (("kernel", kernel_fwd, kernel_both),
                               ("eager", eager_fwd, eager_both),
                               ("sdpa", sdpa_fwd, sdpa_both)):
                o = f()
                err = (o - ref).abs().max().item()
                gap = ((o[:16].double() - ref64).norm(dim=-1) / ref64.norm(dim=-1)).max().item()
                del o
                torch.cuda.reset_peak_memory_stats()
                fwd_ms = timed(f, args.iters)
                with torch.enable_grad():
                    both_ms = timed(b, args.iters)
                row[name] = {"fwd_ms": fwd_ms, "bwd_ms": both_ms - fwd_ms,
                             "fwd_bwd_ms": both_ms, "fwd_tflops": fwd_ops / fwd_ms / 1e9,
                             "max_abs_err_vs_eager": err, "row_gap_vs_fp64": gap,
                             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
                torch.cuda.empty_cache()
        out["shapes"][f"[{args.rows}, {L}, 64]"] = row
        print(json.dumps({f"[{args.rows}, {L}, 64]": row}), flush=True)
        del qkv, q, k, v, g, q4, k4, v4, g4, ref, ref64
        torch.cuda.empty_cache()
    dest = REPO / "chiprun_out" / "time_token_attention_torch.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

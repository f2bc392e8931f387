"""T2T's token attention's share of its roofline: the least time of each
call of ``signal_tpu_torch::token_attention`` (its float32 operations at
the fp32-accurate tensor-core rate, or its bytes at peak bandwidth,
whichever is larger) over the device time the profiler links to the
calls, summed over the window's calls. The count is of what the operator
computes, so it stays put whatever kernel implements it."""

from portbench.t2t_yardstick import token_attention_cost, token_attention_launches

# NVIDIA H100 SXM5 data sheet, dense rates: TF32 on the tensor cores at
# 495 TFLOP/s, of which an fp32-accurate product (3xTF32: three products
# a product) gets a third; HBM3 at 3.35 TB/s
FP32_FLOPS = 495e12 / 3
BW = 3.35e12


def read(ctx):
    if ctx.bw != BW:        # another card: these are not its rates
        return None
    least = spent = 0.0
    for op, us in token_attention_launches(ctx):
        shapes = [s for s in (op.dims or []) if isinstance(s, list) and len(s) == 3]
        if len(shapes) < 2:
            return None
        ops, nbytes = token_attention_cost(shapes[0], shapes[1])
        least += max(ops / FP32_FLOPS, nbytes / BW)
        spent += us / 1e6
    return 100.0 * least / spent if spent > 0 else None

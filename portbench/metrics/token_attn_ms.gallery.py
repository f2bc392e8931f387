"""Device ms a batch of the operations the profiler links to T2T's token
attention (``signal_tpu_torch::token_attention``, both token
transformers), whatever kernels implement it."""

from portbench.t2t_yardstick import token_attention_launches


def read(ctx):
    calls = token_attention_launches(ctx)
    if not calls or not ctx.traced_units:
        return None
    return sum(us for _, us in calls) / 1e3 / ctx.traced_units

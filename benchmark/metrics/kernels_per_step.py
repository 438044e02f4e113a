"""kernels_per_step: every kernel of the traced fit's window, from its
first chunk graph's launch to the end of the last kernel a chunk graph
launched, hand-written and glue, in the graphs and between them, over its
steps (device layer).  The warm-up step and the capture before the first
launch are set-up of the call, not steps, and fall outside."""


def read(ctx):
    if ctx.kind != "train" or not ctx.run.segment_steps:
        return None
    return len(ctx.kernels()) / ctx.run.segment_steps

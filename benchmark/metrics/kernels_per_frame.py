"""kernels_per_frame: every kernel of the traced segment, hand-written and
glue alike, over its frames (device layer)."""


def read(ctx):
    if ctx.kind != "orbit":
        return None
    frames = ctx.frames()
    return len(ctx.kernels()) / len(frames) if frames else None

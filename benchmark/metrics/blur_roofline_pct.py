"""blur_roofline_pct: the least time of the quirk blur (``csrc/bloom.cu``'s
``bloom_rows_kernel``), the frame read once and written once at the card's
memory rate, over the blur's CUPTI time in the traced segment (kernels
layer)."""

from rtbench import yard

NAME = "bloom_rows_kernel"


def read(ctx):
    if ctx.kind != "orbit" or not ctx.run.fx["bloom"]:
        return None
    run = ctx.run
    launches = [b - a for a, b, n in ctx.kernels() if NAME in n]
    if not launches:
        return None
    least = len(launches) * yard.blur_bytes(run.height, run.width) / yard.HBM_BYTES_PER_S
    return 100.0 * least / sum(launches)

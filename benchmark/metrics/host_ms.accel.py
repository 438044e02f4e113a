"""host_ms.accel: the host's time resolving a frame's tree
(``cgrt.render.accel``: ``build_accel``'s routing and its memo look-up,
inside ``cgrt.render.resolve``, on scenes that walk a tree), mean per frame
of the traced segment, from the program's spans (``rtbench/spans.py``;
dispatch layer).  Read under the profiler, whose host activity inflates
it."""

from rtbench import spans


def read(ctx):
    return spans.per_frame_ms(ctx, "cgrt.render.accel")

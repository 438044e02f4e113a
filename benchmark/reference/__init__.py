"""The benchmark's plain reference: a Whitted ray tracer and its inverse
rendering in plain PyTorch, written from the upstream renderer's
semantics (mgokbulut/CG-RayTracer main.cpp, trackball.cpp, ray_tracing.cpp)
as the program documents them.  It imports nothing of the program and
takes nothing the program made: the benchmark hands both sides the same
mesh arrays, lights, cameras and sample seeds, and this package works out
again the rays, hits, sample keys, fractions, images, losses and updates.
"""

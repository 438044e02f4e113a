"""The benchmark harness of ``cg_raytracer_tpu_torch`` (run by
``benchmark/run.py``): the cells of ``BENCHMARK.json``, their traffic,
their timing, the trace's reduction to metrics and the check against the
plain reference (``benchmark/reference``)."""

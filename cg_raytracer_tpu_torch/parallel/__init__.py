"""Multi-device rendering and training over ``torch.distributed``: ray- and
sample-parallel renders and the training step (``sharding.py``), the
process launch, row split and tile recovery (``multihost.py``), and
geometry sharding (``geometry.py``), as in ``cg_raytracer_tpu/parallel/``."""

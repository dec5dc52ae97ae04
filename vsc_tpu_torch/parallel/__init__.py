"""Device meshes, shardings, and accelerator health probing (the port of
``vsc_tpu/parallel``): ``mesh.py`` (the [data, model] mesh, sharded
batches), ``auto.py`` (batch placement for the step CLIs), ``sharding.py``
(the ViT's tensor-parallel rules), ``collectives.py``, ``distributed.py``
(multi-host start-up), ``dryrun.py`` (the sharded full step at a small
size) and ``health.py``."""

from vsc_tpu_torch.parallel.health import (ACCEL_ERROR_EXIT_CODE,
                                           check_accelerator_health)
from vsc_tpu_torch.parallel.mesh import data_sharding, make_mesh, replicated

__all__ = [
    "ACCEL_ERROR_EXIT_CODE",
    "check_accelerator_health",
    "data_sharding",
    "make_mesh",
    "replicated",
]

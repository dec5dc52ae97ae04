"""
Multi-host initialization
=========================

Port of ``vsc_tpu/parallel/distributed.py``. Inside a host one process
drives every card through its mesh (``parallel/mesh.py``); across hosts the
processes join one ``torch.distributed`` process group, as the JAX package
joins hosts with ``jax.distributed``. The data axis then spans the
processes: each takes its rank's slice of a batch and splits it over its
own mesh. As in the JAX package, no inference collective crosses hosts;
the group carries start-up and the gathering of results
(``parallel/dryrun.py --processes``). The step CLIs stay single-process::

    from vsc_tpu_torch.parallel.distributed import initialize
    initialize()        # torchrun's environment (MASTER_ADDR, WORLD_SIZE > 1)
    initialize(coordinator="host0:1234", num_processes=4, process_id=i)

Without either it is a no-op, so every CLI runs unchanged on one host.
"""

from __future__ import annotations

import os

__all__ = ["initialize", "is_multi_host", "backend_for"]

_initialized = False


def backend_for(num_processes: int) -> str:
    """NCCL where each of the host's processes has a card of its own, else
    gloo (which runs on the CPU, and where processes share a card)."""
    import torch
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> bool:
    """Join the process group when running multi-host; no-op (returns
    False) for single-process runs. ``coordinator`` is "host:port" of
    process 0; without it torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK`` are read. ``backend`` defaults to
    ``backend_for(num_processes)``."""
    global _initialized
    if _initialized:
        return True
    env_driven = (bool(os.environ.get("MASTER_ADDR"))
                  and int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if coordinator is None and not env_driven:
        return False
    if coordinator is None:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ.get("RANK", "0"))
    elif num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator needs num_processes and "
                         "process_id")
    import torch.distributed as dist
    dist.init_process_group(
        backend=backend or backend_for(num_processes),
        init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id)
    _initialized = True
    return True


def is_multi_host() -> bool:
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)

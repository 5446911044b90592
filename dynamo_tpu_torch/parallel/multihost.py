"""Joining the ranks of a mesh: one process per rank, on one node or many.

Counterpart of ``dynamo_tpu/parallel/multihost.py``. There,
``jax.distributed`` forms one multi-controller runtime over every
process's chips and XLA inserts the collectives. Here each rank is a
process that drives one card (or the CPU) and joins
``torch.distributed``'s default process group at the coordinator's
address; the collectives are the port's own (``parallel/comm.py``). The
worker's leader/follower step replication (``backends/torch/multihost.py``)
keeps the ranks' schedulers in lockstep, on one node (``--tp``, ``--dp``,
``--pp``) as across nodes (``--nnodes``; not with ``--pp``). A world is
dp x tp ranks or pp stages.

The counterpart of ``force_cpu_devices`` is ranks on the CPU (gloo);
``fetch_replicated*`` have none: a rank's outputs are on its own device,
identical on every rank, and read there.
"""

from __future__ import annotations

import logging
from datetime import timedelta

from dynamo_tpu_torch.parallel import comm

log = logging.getLogger("dynamo_tpu_torch.multihost")


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   backend: str = comm.GLOO, timeout_s: float = 600.0) -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, through the coordinator at ``coordinator``
    (``host:port`` or ``tcp://host:port``; rank 0 listens there).
    ``backend`` is the collective backend of the mesh
    (``comm.choose_backend``). A rank that cannot join raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("this process has joined a process group already")
    addr = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        comm.process_group_backend(backend), init_method=addr,
        world_size=num_processes, rank=process_id, timeout=timedelta(seconds=timeout_s),
    )
    log.info("process group up: rank %d/%d over %s (%s)", process_id, num_processes,
             dist.get_backend(), backend)


def shutdown_multihost() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()

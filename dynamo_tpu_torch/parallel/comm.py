"""The collectives of tensor parallelism, made explicit.

The JAX engine runs one program over a device mesh and XLA inserts the
collectives: a psum after the row-parallel ``wo`` and ``w_down`` products
and the gather of the vocab-split ``lm_head``'s logits
(``dynamo_tpu/parallel/sharding.py``). A PyTorch process drives one card,
so the port runs one process per rank and calls those two collectives
itself, on the mesh's process group:

- :func:`all_reduce` sums a rank's partial product over the ranks;
- :func:`all_gather` joins the ranks' column blocks along the last axis.

The backend follows from the ranks' devices (:func:`choose_backend`) and
is fixed when the mesh is built, never on a failure: NCCL when every
rank of a node has a card of its own; gloo when the ranks run on the
CPU; gloo through host memory when ranks share a card (NCCL refuses two
ranks on one GPU), each collective then copying its tensor to the host
and back. A collective that fails raises.

Each call adds one to ``calls`` (by collective) where it runs, and
nowhere else; a CUDA graph that captured collectives adds them again at
each replay (``engine/graphs.py``), as it does the attention kernel's
launches.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

NCCL, GLOO, GLOO_HOST = "nccl", "gloo", "gloo-host"
BACKENDS = (NCCL, GLOO, GLOO_HOST)

# Collective calls since the last reset, by collective.
calls = {"all_reduce": 0, "all_gather": 0}


def reset_calls() -> None:
    for name in calls:
        calls[name] = 0


def choose_backend(devices: Sequence[Any], ranks_per_node: int | None = None) -> str:
    """The collective backend of ranks on ``devices`` (one per rank, in
    rank order; ``ranks_per_node`` consecutive ranks share a node, all of
    them by default): ``gloo`` for CPU ranks, ``nccl`` when no two ranks
    of a node name the same card, ``gloo-host`` when some do. CPU and
    CUDA ranks in one mesh raise."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return GLOO
    if kinds != {"cuda"}:
        raise ValueError(f"a mesh's ranks run all on the CPU or all on cards, got {devs}")
    k = ranks_per_node or len(devs)
    for n in range(0, len(devs), k):
        cards = [d.index or 0 for d in devs[n : n + k]]
        if len(set(cards)) < len(cards):
            return GLOO_HOST
    return NCCL


def process_group_backend(backend: str) -> str:
    """The ``torch.distributed`` backend that carries ``backend``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown collective backend {backend!r} (expected one of {BACKENDS})")
    return NCCL if backend == NCCL else GLOO


def all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, in place (``x`` itself at
    tp = 1, with no call)."""
    if mesh is None or mesh.tp == 1:
        return x
    import torch.distributed as dist

    calls["all_reduce"] += 1
    if mesh.backend == GLOO_HOST:
        host = x.cpu()
        dist.all_reduce(host, group=mesh.group)
        return x.copy_(host)
    dist.all_reduce(x, group=mesh.group)
    return x


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' ``x`` joined along the last axis in rank order (``x``
    itself at tp = 1, with no call)."""
    if mesh is None or mesh.tp == 1:
        return x
    import torch.distributed as dist

    calls["all_gather"] += 1
    if mesh.backend == NCCL:
        out = torch.empty((mesh.tp, *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
        parts = list(out.unbind(0))
    else:
        src = x.contiguous().cpu() if mesh.backend == GLOO_HOST else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.tp)]
        dist.all_gather(parts, src, group=mesh.group)
        parts = [p.to(x.device) for p in parts]
    return torch.cat(parts, dim=-1)


def warm_up(mesh) -> None:
    """One small all-reduce, so that a backend's communicator exists
    before the first CUDA graph capture (NCCL creates it lazily at the
    first collective, which must not fall inside a capture). Not
    counted."""
    if mesh is None or mesh.tp == 1:
        return
    import torch.distributed as dist

    t = torch.ones(1, device=mesh.device if mesh.backend == NCCL else "cpu")
    dist.all_reduce(t, group=mesh.group)
    if int(t.item()) != mesh.tp:
        raise RuntimeError(f"warm-up all-reduce gave {t.item()}, expected {mesh.tp}")

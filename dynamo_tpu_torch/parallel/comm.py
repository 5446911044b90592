"""The collectives of tensor, data and pipeline parallelism, made explicit.

The JAX engine runs one program over a device mesh and XLA inserts the
collectives: a psum after the row-parallel ``wo`` and ``w_down`` products
and the gather of the vocab-split ``lm_head``'s logits
(``dynamo_tpu/parallel/sharding.py``), the gathers that keep a
dp-replicated cache equal and a dp-split decode batch's outputs
replicated, and the ``ppermute`` stage hop and ``psum`` exit of a
pipeline (``dynamo_tpu/parallel/pipeline.py``). A PyTorch process drives
one card, so the port runs one process per rank and calls them itself:

- :func:`all_reduce` sums a rank's partial product over the tp ranks;
- :func:`all_gather` joins the tp ranks' column blocks along the last axis
  (or their token slices along the first, after an all-to-all expert
  dispatch);
- :func:`all_to_all` sends a rank's ``i``-th block to rank ``i`` and joins
  what each rank sent it, in rank order (``jax.lax.all_to_all`` of the
  expert-parallel dispatch, ``engine/model._moe_dispatch_a2a``);
- :func:`dp_gather` joins the dp ranks' lane blocks along an axis;
- :func:`ring_exchange` passes a tensor one step round the ring of a
  sequence-parallel group (the counterpart of ``ppermute`` in
  ``dynamo_tpu/ops/ring_attention.py``): rank ``r`` sends to ``(r + 1) mod
  sp`` and receives from ``(r - 1) mod sp``, the send started first
  (``isend``) so that no two neighbours wait on each other;
  :func:`sp_gather` joins the sp ranks' chunks and :func:`sp_broadcast`
  replicates one rank's tensor on the others;
- :func:`send_next` and :func:`recv_prev` hop an activation one pipeline
  stage forward (the counterpart of ``ppermute``). The stages form a
  chain, not a ring: stage ``s`` only sends to ``s + 1`` and receives
  from ``s - 1``, sends do not wait for their receiver
  (``isend``; :func:`wait_sends` collects them), so no two neighbours
  can wait on each other;
- :func:`exit_broadcast` replicates the last stage's rows on every stage
  (the counterpart of a ``psum`` with one contributor, so bit for bit);
- :func:`stage_gather` joins the stages' vocab slices of the logits;
- :func:`page_gather` joins the ranks' parts of a batch of KV pages on
  rank 0, and :func:`page_scatter` hands each rank its part of rank 0's
  batch: the disaggregated transfer's and the peer page server's wire
  page is the whole combined page ``[L, bs, 2*n_kv, d]``, and a tp rank
  holds its slice of the combined heads, a pipeline stage its layers, a
  dp or sp rank a whole replica (JAX's GSPMD gathers and re-splits the
  page, ``dynamo_tpu/engine/core.py`` ``read_held_pages``);
  :func:`page_count` agrees how many pages every rank can serve. They run
  eagerly, outside any CUDA graph, and their host wall time is summed
  in ``seconds``.

The backend follows from the ranks' devices (:func:`choose_backend`) and
is fixed when the mesh is built, never on a failure: NCCL when every
rank of a node has a card of its own; gloo when the ranks run on the
CPU; gloo through host memory when ranks share a card (NCCL refuses two
ranks on one GPU), each collective then copying its tensor to the host
and back (2-byte floats travel as their bytes: these collectives copy,
never add). A collective that fails raises.

Each call adds one to ``calls`` (by collective) where it runs, and
nowhere else; a CUDA graph that captured collectives adds them again at
each replay (``engine/graphs.py``), as it does the attention kernel's
launches.
"""

from __future__ import annotations

import time
from typing import Any, Sequence

import torch

NCCL, GLOO, GLOO_HOST = "nccl", "gloo", "gloo-host"
BACKENDS = (NCCL, GLOO, GLOO_HOST)

# Collective calls since the last reset, by collective.
calls = {"all_reduce": 0, "all_gather": 0, "dp_gather": 0, "send": 0, "recv": 0,
         "broadcast": 0, "stage_gather": 0, "all_to_all": 0, "ring_send": 0, "ring_recv": 0,
         "sp_gather": 0, "sp_broadcast": 0, "page_gather": 0, "page_scatter": 0,
         "page_count": 0}
# Host wall seconds of the page collectives since the last reset.
seconds = {"page_gather": 0.0, "page_scatter": 0.0}


def reset_calls() -> None:
    for name in calls:
        calls[name] = 0
    for name in seconds:
        seconds[name] = 0.0


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


def _bits(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a dtype every backend moves (gloo has no bf16 and no int16):
    2-byte floats as their bytes, the last axis doubled (for collectives
    that copy, never add)."""
    return x.view(torch.uint8) if x.dtype in (torch.bfloat16, torch.float16) else x


def _gather(x: torch.Tensor, group, n: int, backend: str, dim: int) -> torch.Tensor:
    """The ``n`` ranks' ``x`` of ``group`` joined along ``dim`` in rank
    order."""
    import torch.distributed as dist

    src = _bits(x.contiguous())
    if backend == NCCL:
        out = torch.empty((n, *src.shape), dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
        parts = list(out.unbind(0))
    else:
        src = src.cpu() if backend == GLOO_HOST else src
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        parts = [p.to(x.device) for p in parts]
    return torch.cat(parts, dim=dim).view(x.dtype)


def all_gather(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """The tp ranks' ``x`` joined along ``dim`` (the last axis by default)
    in rank order (``x`` itself at tp = 1, with no call)."""
    if mesh is None or mesh.tp == 1:
        return x
    calls["all_gather"] += 1
    return _gather(x, mesh.group, mesh.tp, mesh.backend, dim)


def all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` ``[tp, ...]``: block ``i`` goes to tp rank ``i``; returns the
    blocks the ranks sent this one, ``[tp, ...]`` in rank order (a copy,
    never a sum: 2-byte floats travel as their bytes)."""
    import torch.distributed as dist

    calls["all_to_all"] += 1
    src = _bits(x.contiguous())
    if mesh.backend == GLOO_HOST:
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    return out.to(x.device).view(x.dtype)


def dp_gather(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The dp ranks' ``x`` (each its lane block) joined along ``dim`` in dp
    order, the same on every rank (``x`` itself at dp = 1, with no call)."""
    if mesh is None or mesh.dp == 1:
        return x
    calls["dp_gather"] += 1
    return _gather(x, mesh.dp_group, mesh.dp, mesh.backend, dim)


def send_next(x: torch.Tensor, mesh):
    """Start sending ``x`` to the next pipeline stage; returns the pending
    send (with the tensor it reads) for :func:`wait_sends`."""
    import torch.distributed as dist

    calls["send"] += 1
    src = _bits(x.contiguous())
    if mesh.backend == GLOO_HOST:
        src = src.cpu()
    return dist.isend(src, mesh.stage + 1, group=mesh.group), src


def recv_prev(shape: tuple, dtype: torch.dtype, mesh) -> torch.Tensor:
    """The activation the previous pipeline stage sent, on this stage's
    device."""
    import torch.distributed as dist

    calls["recv"] += 1
    host = mesh.backend == GLOO_HOST
    buf = torch.empty(shape, dtype=dtype, device="cpu" if host else mesh.device)
    dist.recv(_bits(buf), mesh.stage - 1, group=mesh.group)
    return buf.to(mesh.device) if host else buf


def ring_exchange(xs: list[torch.Tensor], mesh, between=None) -> list[torch.Tensor]:
    """The tensors ``xs`` of the previous rank of the sp ring, on this
    rank's device, after this rank's were sent to the next: the sends are
    started first (``isend``, one per tensor), ``between()`` runs while
    they travel (a block of the ring's attention), then the receives, then
    the sends are waited for. A 2-byte float travels as its bytes."""
    import torch.distributed as dist

    sp, r = mesh.sp, mesh.rank
    host = mesh.backend == GLOO_HOST
    srcs = [_bits(x.contiguous()) for x in xs]
    if host:  # through pinned buffers: a pageable copy of a chunk runs at a fraction of the rate
        srcs = [torch.empty(s.shape, dtype=s.dtype, pin_memory=True).copy_(s) for s in srcs]
    works = []
    for s in srcs:
        calls["ring_send"] += 1
        works.append(dist.isend(s, (r + 1) % sp, group=mesh.group))
    if between is not None:
        between()
    out = []
    for x, s in zip(xs, srcs):
        buf = torch.empty_like(s, pin_memory=host)
        calls["ring_recv"] += 1
        dist.recv(buf, (r - 1) % sp, group=mesh.group)
        out.append((buf.to(x.device) if host else buf).view(x.dtype))
    for work in works:
        work.wait()
    return out


def sp_gather(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The sp ranks' ``x`` (each its chunk of the sequence) joined along
    ``dim`` in rank order."""
    calls["sp_gather"] += 1
    return _gather(x, mesh.group, mesh.sp, mesh.backend, dim)


def sp_broadcast(x: torch.Tensor, src: int, mesh) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every sp rank (the others pass a tensor of
    its shape and dtype; a copy, bit for bit)."""
    calls["sp_broadcast"] += 1
    return _broadcast(x, src, mesh)


def _broadcast(x: torch.Tensor, src: int, mesh) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank of the mesh's group."""
    import torch.distributed as dist

    buf = _bits(x.contiguous())
    if mesh.backend == GLOO_HOST:
        host = buf.cpu()
        dist.broadcast(host, src, group=mesh.group)
        buf = host.to(x.device)
    else:
        dist.broadcast(buf, src, group=mesh.group)
    return buf.view(x.dtype)


def wait_sends(pending: list) -> None:
    """Wait for the sends :func:`send_next` started."""
    for work, _ in pending:
        work.wait()
    pending.clear()


def exit_broadcast(x: torch.Tensor, mesh) -> torch.Tensor:
    """The last pipeline stage's ``x``, on every stage (in place; the
    other stages pass a tensor of its shape and dtype)."""
    calls["broadcast"] += 1
    return _broadcast(x, mesh.pp - 1, mesh)


def stage_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """The stages' ``x`` (each its vocab slice of the logits) joined along
    the last axis in stage order."""
    calls["stage_gather"] += 1
    return _gather(x, mesh.group, mesh.pp, mesh.backend, -1)


def warm_up(mesh) -> None:
    """One small all-reduce on each of the mesh's groups, so that a
    backend's communicators exist before the first CUDA graph capture
    (NCCL creates them lazily at the first collective, which must not fall
    inside a capture); on a pipeline also one send from each stage to the
    next, since NCCL opens each pair's point-to-point connection at its
    first send. Not counted."""
    import torch.distributed as dist

    if mesh is None:
        return
    dev = mesh.device if mesh.backend == NCCL else "cpu"
    for group, n in mesh.groups():
        t = torch.ones(1, device=dev)
        dist.all_reduce(t, group=group)
        if int(t.item()) != n:
            raise RuntimeError(f"warm-up all-reduce gave {t.item()}, expected {n}")
    if getattr(mesh, "pp", 1) > 1:
        # Down the chain: each stage receives, then sends.
        t = torch.full((1,), float(mesh.stage), device=dev)
        if mesh.stage > 0:
            dist.recv(t, mesh.stage - 1, group=mesh.group)
            if int(t.item()) != mesh.stage - 1:
                raise RuntimeError(f"warm-up hop gave {t.item()}, expected {mesh.stage - 1}")
            t.fill_(float(mesh.stage))
        if mesh.stage + 1 < mesh.pp:
            dist.send(t, mesh.stage + 1, group=mesh.group)


# -- KV pages -------------------------------------------------------------
#
# A batch of pages is ``[n, L, bs, 2*n_kv, d]`` (int8: ``{"kv": that, "scale":
# [n, L, bs, 2*n_kv]}``): a tp rank holds its slice of axis 3 (its combined
# heads, in rank order), a pipeline stage its slice of axis 1 (its layers),
# a dp or sp rank the whole page.


def _page_split(mesh) -> tuple[int, int, Any] | None:
    """(the axis of a page batch ``mesh`` splits, its parts, the group of
    the ranks that hold rank 0's parts), or None where a rank holds whole
    pages."""
    if getattr(mesh, "pp", 1) > 1:
        return 1, mesh.pp, mesh.group
    if getattr(mesh, "tp", 1) > 1:
        return 3, mesh.tp, mesh.group
    return None


def _leaves(pages) -> dict:
    return pages if isinstance(pages, dict) else {None: pages}


def _unleaves(leaves: dict):
    return leaves[None] if None in leaves else leaves


def _page_device(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` where the backend moves it: on the rank's card for NCCL, on the
    host for gloo."""
    return x.to(mesh.device) if mesh.backend == NCCL else x.cpu()


def page_count(n: int, mesh) -> int:
    """The least of every rank's ``n``: how many pages of a hash chain every
    rank can read (a page missed on one rank's tier ends the chain for all,
    so that their allocators pin the same blocks)."""
    import torch.distributed as dist

    calls["page_count"] += 1
    t = _page_device(torch.tensor([n], dtype=torch.int64), mesh)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def page_gather(pages, mesh):
    """Rank 0's whole pages from every rank's part (``pages``: this rank's
    batch, a tensor or int8's ``{kv, scale}``), joined in rank order on the
    host (on rank 0's card over NCCL); None on every other rank. A rank
    whose parts rank 0 does not need (a dp replica but the first, an sp
    rank but rank 0) calls nothing. A 2-byte float travels as its bytes."""
    import torch.distributed as dist

    split = _page_split(mesh)
    if split is None or getattr(mesh, "dp_rank", 0) != 0:
        return pages if mesh.rank == 0 else None
    axis, n, group = split
    t0 = time.perf_counter()
    calls["page_gather"] += 1
    out = {}
    for k, x in _leaves(pages).items():
        src = _page_device(_bits(x.contiguous()), mesh)
        parts = [torch.empty_like(src) for _ in range(n)] if mesh.rank == 0 else None
        dist.gather(src, parts, dst=0, group=group)
        if mesh.rank == 0:
            out[k] = torch.cat(parts, dim=axis).view(x.dtype)
    seconds["page_gather"] += time.perf_counter() - t0
    return _unleaves(out) if mesh.rank == 0 else None


def page_scatter(pages, out, mesh):
    """This rank's part of rank 0's whole pages ``pages`` (None on the other
    ranks), received into ``out`` (a host batch of this rank's part, a
    tensor or int8's ``{kv, scale}``; over NCCL a batch on the card like
    it is returned instead). Every rank of the world takes part: a tp
    rank gets its heads (each dp replica the same), a stage its layers, a
    dp or sp rank the whole pages. A 2-byte float travels as its bytes."""
    import torch.distributed as dist

    world = dist.get_world_size()
    split = _page_split(mesh)
    t0 = time.perf_counter()
    calls["page_scatter"] += 1
    got = {}
    whole = _leaves(pages) if pages is not None else None
    for k, buf in _leaves(out).items():
        dst = _page_device(_bits(buf), mesh) if mesh.backend == NCCL else _bits(buf)
        parts = None
        if whole is not None:
            x = _bits(whole[k])
            if split is None:
                chunks = [x] * world
            else:
                axis, n, _ = split
                # The parts along the axis, in rank order; a dp replica's
                # ranks take the first replica's (rank r holds tp shard r % tp).
                chunks = [c.contiguous() for c in torch.chunk(x, n, dim=axis)]
                chunks = [chunks[r % n] for r in range(world)]
            parts = [_page_device(c, mesh) for c in chunks]
        dist.scatter(dst, parts, src=0)
        got[k] = dst.view(buf.dtype)
    seconds["page_scatter"] += time.perf_counter() - t0
    return _unleaves(got)

"""Tensor and data parallelism for the port: one process per rank.

Counterpart of ``dynamo_tpu/parallel/sharding.py``, with the same layouts
(classic megatron over the ``tp`` axis):

- fused ``wqkv`` (and Qwen2's ``bqkv``): column-parallel in the
  shard-blocked layout (``[q_s | k_s | v_s]`` per shard, ``model.fuse_qkv``),
  so rank ``s`` holds its own q, k and v heads;
- ``wo`` and ``w_down``: row-parallel, followed by an all-reduce;
- fused ``wgu``: column-parallel, shard-blocked the same way;
- ``lm_head``: vocab-split, its logits gathered before sampling; tied
  embeddings stay replicated;
- the paged KV cache: the combined-head axis split over tp, so a rank
  holds the K and V pages of its own KV heads.

Over ``dp`` the params and the cache are replicated, and a decode
megastep's batch is split: dp rank ``d`` computes the ``d``-th contiguous
block of its lanes (:func:`dp_lane_block`, the counterpart of
``decode_batch_shardings``). Every other dispatch runs whole on every dp
rank, as in JAX, whose prefill inputs are replicated.

The JAX engine is a single controller whose mesh spans the devices; XLA
places each leaf by its ``PartitionSpec`` and inserts the collectives. A
PyTorch process drives one card, so here each rank is a process of its
own that holds its shard (:func:`shard_params`) and calls the collectives
of ``parallel/comm.py``. A spec is a tuple with the entries of JAX's
``PartitionSpec`` (``None`` or ``"tp"`` per axis), so the two compare as
tuples.

``tp`` must divide num_heads, num_kv_heads and intermediate_size (llama3
GQA: tp <= 8).

The fused params must have been built with THIS tp (``init_params(cfg,
seed, tp=...)``, ``load_hf_llama(path, tp=...)``): the shard-blocked column
order depends on it. A params dict fused for tp > 1 carries ``fuse_tp``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.parallel import comm

TP = "tp"


@dataclass(frozen=True)
class Mesh:
    """This process's place in a dp x tp mesh: the axis sizes, its rank
    (``dp_rank * tp + tp_rank``, JAX's ``devices.reshape(dp, tp)``), every
    rank's device (rank order), the process groups of the tp axis and of
    the dp axis that hold this rank (None where the axis is 1) and the
    collective backend (``comm.choose_backend``). ``lanes`` marks the view
    a decode forward over this rank's lane block runs under
    (:meth:`lane_view`): the K/V rows it writes are gathered over dp."""

    dp: int
    tp: int
    rank: int
    devices: tuple[torch.device, ...]
    backend: str
    group: Any = None
    dp_group: Any = None
    lanes: bool = False

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def tp_rank(self) -> int:
        """This rank's shard of the tp axis."""
        return self.rank % self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    def groups(self) -> list[tuple[Any, int]]:
        """(group, size) of each axis above 1."""
        return [(g, n) for g, n in ((self.group, self.tp), (self.dp_group, self.dp)) if n > 1]

    def lane_view(self) -> "Mesh":
        return dataclasses.replace(self, lanes=True)


def dp_lane_block(mesh: Mesh, width: int) -> tuple[int, int]:
    """The lanes ``[lo, hi)`` of a decode dispatch of ``width`` lanes that
    this dp rank computes: its contiguous block, as JAX's
    ``P("dp")`` splits the batch axis."""
    if width % mesh.dp:
        raise ValueError(f"decode width {width} not a multiple of dp={mesh.dp}")
    n = width // mesh.dp
    return mesh.dp_rank * n, (mesh.dp_rank + 1) * n


def default_devices(world: int, nnodes: int = 1) -> list[torch.device]:
    """One card per rank, ``cuda:0 .. cuda:k-1`` on each node of ``k =
    world / nnodes`` ranks. Fewer cards on this node than ranks raises:
    ranks share a card only where the caller lists their devices."""
    k = world // nnodes
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < k:
        raise ValueError(
            f"{k} ranks per node need {k} cards, this node has {have}; list the ranks' "
            "devices explicitly to share a card (make_mesh(devices=...), the worker's "
            "--tp-devices) or run the ranks on the CPU"
        )
    return [torch.device("cuda", i) for _ in range(nnodes) for i in range(k)]


def join_group(world: int, rank: int | None, backend: str, devices) -> int:
    """Check that the default process group is up with ``world`` ranks and
    the process-group backend ``backend`` calls for; returns this
    process's rank (``rank`` must be it, when given)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {world} ranks needs the process group up first "
            "(parallel.multihost.init_multihost)"
        )
    if dist.get_world_size() != world:
        raise ValueError(f"the process group has {dist.get_world_size()} ranks, the mesh {world}")
    want = comm.process_group_backend(backend)
    if dist.get_backend() != want:
        raise ValueError(
            f"ranks on {[str(d) for d in devices]} need the {want} process group "
            f"({backend}), it is {dist.get_backend()}"
        )
    rank = dist.get_rank() if rank is None else rank
    if rank != dist.get_rank():
        raise ValueError(f"rank {rank} is not this process's ({dist.get_rank()})")
    return rank


def make_mesh(dp: int = 1, tp: int = 1, devices=None, rank: int | None = None,
              nnodes: int = 1) -> Mesh:
    """This process's mesh of ``dp x tp`` ranks. ``devices`` (one per rank,
    rank order) defaults to one card per rank (:func:`default_devices`);
    ``rank`` to this process's rank in the default process group, which
    must be up above one rank (``parallel/multihost.init_multihost``) with
    a world of dp x tp ranks and the backend the devices call for. Every
    rank creates every tp and dp group, in one order
    (``torch.distributed.new_group`` is collective). The backend is
    printed."""
    world = dp * tp
    if dp < 1 or tp < 1 or world % nnodes:
        raise ValueError(f"mesh {dp}x{tp} must be positive, in ranks a multiple of "
                         f"nnodes={nnodes}")
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else default_devices(world, nnodes))]
    if world > len(devices):
        raise ValueError(f"mesh {dp}x{tp} needs {world} devices, have {len(devices)}")
    devices = devices[:world]
    backend = comm.choose_backend(devices, world // nnodes)
    group = dp_group = None
    if world > 1:
        import torch.distributed as dist

        rank = join_group(world, rank, backend, devices)
        if dp == 1:
            group = dist.group.WORLD
        else:
            for d in range(dp):
                g = dist.new_group([d * tp + t for t in range(tp)]) if tp > 1 else None
                if d == rank // tp:
                    group = g
            for t in range(tp):
                g = dist.new_group([d * tp + t for d in range(dp)])
                if t == rank % tp:
                    dp_group = g
    rank = 0 if rank is None else rank
    mesh = Mesh(dp, tp, rank, tuple(devices), backend, group, dp_group)
    if world > 1:
        if backend != comm.GLOO:
            torch.cuda.set_device(mesh.device)
        comm.warm_up(mesh)
        print(f"{dp}x{tp} mesh: rank {rank}/{world} (dp {mesh.dp_rank}, tp {mesh.tp_rank}) "
              f"on {mesh.device}, collectives over {backend}", flush=True)
    return mesh


def rank_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The shapes one rank computes: its query heads, KV heads and MLP
    columns (``cfg`` itself at tp = 1)."""
    if tp == 1:
        return cfg
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size // tp,
    )


def param_partition_specs(cfg: ModelConfig, tp: int) -> dict[str, Any]:
    """Spec pytree matching ``model.init_params``'s structure (mesh-free:
    also used for memory planning, ``parallel/placement.py``), with the
    JAX function's entries and divisibility errors."""
    for what, n in (
        ("num_kv_heads", cfg.num_kv_heads),
        ("num_heads", cfg.num_heads),
        ("intermediate_size", cfg.intermediate_size),
    ):
        if n % tp:
            raise ValueError(f"tp={tp} must divide {what}={n}")

    layers: dict[str, tuple] = {
        "attn_norm": (None, None),
        "mlp_norm": (None, None),
        "wqkv": (None, None, TP),
        "wo": (None, TP, None),
    }
    if cfg.attn_qkv_bias:
        layers["bqkv"] = (None, TP)  # fused column order, like wqkv
    if cfg.is_moe:
        if cfg.num_experts % tp:
            raise ValueError(f"tp={tp} must divide num_experts={cfg.num_experts}")
        layers["w_router"] = (None, None, None)
        layers["w_gate"] = (None, TP, None, None)
        layers["w_up"] = (None, TP, None, None)
        layers["w_down"] = (None, TP, None, None)
    else:
        layers["wgu"] = (None, None, TP)
        layers["w_down"] = (None, TP, None)
    specs: dict[str, Any] = {
        "embed": (None, None),
        "layers": layers,
        "final_norm": (None,),
        "fuse_tp": (),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, TP)
    return specs


def cache_sharding(cfg: ModelConfig, tp: int) -> tuple:
    """Spec of one layer's pages ``[n_pages, page_size, 2*n_kv, d]`` (the
    combined-head axis over tp, so K and V of a head share a rank) and
    the combined heads a rank holds."""
    if cfg.num_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide num_kv_heads={cfg.num_kv_heads}")
    return (None, None, TP, None), 2 * cfg.num_kv_heads // tp


def expand_specs_for_params(specs: Any, params: Any) -> Any:
    """Match a spec pytree to a possibly int8-quantized params dict: where
    params holds ``{"w", "scale"}`` under one spec leaf, expand to
    per-member specs. ``scale`` is ``w``'s shape with the contraction axis
    collapsed to 1, so an axis that is size 1 in scale (row-parallel
    weights: wo, w_down) replicates instead."""
    def expand(spec, p):
        if isinstance(p, dict) and set(p) == {"w", "scale"}:
            scale_spec = tuple(
                ax if p["scale"].shape[i] != 1 else None for i, ax in enumerate(spec)
            )
            return {"w": spec, "scale": scale_spec}
        if isinstance(p, dict):
            return {k: expand(spec[k], p[k]) for k in p}
        return spec

    return {k: expand(specs[k], params[k]) for k in params}


def take_shard(x: torch.Tensor, spec: tuple, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``x`` along the axis ``spec`` names (a copy
    of its own), or ``x`` where no axis is split. ``spec`` may be longer
    than ``x``'s rank: its trailing entries then apply (a stacked leaf's
    spec on one layer)."""
    spec = spec[len(spec) - x.dim():]
    if TP not in spec or tp == 1:
        return x
    axis = spec.index(TP)
    if x.shape[axis] % tp:
        raise ValueError(f"tp={tp} must divide the split axis {axis} of shape {tuple(x.shape)}")
    n = x.shape[axis] // tp
    return x.narrow(axis, rank * n, n).clone(memory_format=torch.contiguous_format)


def shard_params(params: dict, cfg: ModelConfig, mesh: Mesh) -> dict:
    """This rank's shard of a full params dict fused for the mesh's tp
    (possibly int8-quantized): each leaf's block along its spec's tp axis.
    The marker ``fuse_tp`` is kept."""
    specs = param_partition_specs(cfg, mesh.tp)
    if "fuse_tp" not in params:
        specs.pop("fuse_tp")
    specs = expand_specs_for_params(specs, params)

    def shard(x, spec):
        if isinstance(x, dict):
            return {k: shard(x[k], spec[k]) for k in x}
        if not isinstance(x, torch.Tensor):
            return x
        return take_shard(x, spec, mesh.tp, mesh.rank % mesh.tp)  # the rank's tp shard

    return {k: shard(params[k], specs[k]) for k in params}


def reblock(x: torch.Tensor, sizes: list[int], tp: int) -> torch.Tensor:
    """A fused projection's columns (last axis) from the tp = 1 layout
    ``[a | b | ...]`` (blocks of ``sizes``) to the shard-blocked layout
    ``[a_0 | b_0 | ... | a_1 | b_1 | ...]`` of ``tp`` shards."""
    if tp == 1:
        return x
    parts = [torch.chunk(p, tp, dim=-1) for p in torch.split(x, sizes, dim=-1)]
    return torch.cat([blk for s in range(tp) for blk in (p[s] for p in parts)], dim=-1)


def fused_sizes(name: str, cfg: ModelConfig) -> list[int] | None:
    """The blocks of a fused leaf's columns in the tp = 1 layout (None for
    a leaf that is not fused)."""
    if name in ("wqkv", "bqkv"):
        return [cfg.q_size, cfg.kv_size, cfg.kv_size]
    if name == "wgu":
        return [cfg.intermediate_size, cfg.intermediate_size]
    return None

"""Pipeline parallelism for the port: layer stages, one process each.

Counterpart of ``dynamo_tpu/parallel/pipeline.py``. There the whole
fill/drain pipeline is one jitted ``shard_map`` program over a ``("pp",)``
device mesh: every stage runs the same code on its layer slice and the
activations rotate with ``lax.ppermute``. A PyTorch process drives one
card, so here each stage is a process of its own (on the rank machinery
of ``parallel/multihost.py``) that runs the same rounds as an explicit
loop, with the hops and exits of ``parallel/comm.py``:

- **Layer stages.** Stage ``s`` holds layers ``[s*L/pp, (s+1)*L/pp)`` of
  every stacked leaf (:func:`stage_params`; an int8 ``{w, scale}`` pair
  goes whole to its stage) and a cache of those layers only; embeddings,
  the final norm and ``lm_head`` are replicated (:func:`pp_param_specs`).
- **GPipe prefill** (:func:`pp_forward_tokens`). The ragged batch splits
  into ``M`` equal row chunks on the host (:func:`plan_microbatches`,
  JAX's plan array for array). Round ``r`` has stage ``s`` working
  microbatch ``r - s``: stage 0 embeds it, a later stage receives it
  from the one before, and each sends its output to the next. A stage
  skips the rounds in which it has no microbatch, and so does its
  neighbour's matching send: only real work is sent. The last stage
  banks each sequence's final-norm row the round its microbatch drains,
  and :func:`comm.exit_broadcast` replicates them (JAX's ``psum`` with
  one contributor), so the logits and the sampling above them run
  identically on every stage.
- **Wavefront decode** (:func:`pp_decode_round`). ``B`` lanes form ``M``
  groups; round ``r`` has stage ``s`` advance work item ``r - s`` (decode
  step ``(r - s) // M`` of group ``(r - s) % M``). The item draining the
  last stage is broadcast to every stage, each computes its ``V/pp``
  slice of the logits (``model.logits_slice``) and the slices are
  gathered, so every stage samples the same token.

The stages form a chain, not a ring (JAX's ``ppermute`` also carries the
last stage's junk back to stage 0): stage ``s`` sends only to ``s + 1``,
without waiting for the receive, so no two stages wait on each other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.parallel import comm

PP = "pp"


@dataclass(frozen=True)
class PPMesh:
    """This process's place in a pipeline: the stage count, its stage
    (its rank: a pipeline is a world of pp ranks, stage s at rank s),
    every stage's device
    (stage order), the process group (None at pp = 1) and the collective
    backend (``comm.choose_backend``)."""

    pp: int
    stage: int
    devices: tuple[torch.device, ...]
    backend: str
    group: Any = None

    @property
    def device(self) -> torch.device:
        return self.devices[self.stage]

    @property
    def rank(self) -> int:
        return self.stage

    def groups(self) -> list[tuple[Any, int]]:
        return [(self.group, self.pp)] if self.pp > 1 else []


def make_pp_mesh(pp: int, devices=None, rank: int | None = None) -> PPMesh:
    """This process's stage of a ``pp``-stage pipeline. ``devices`` (one per
    stage) defaults to one card per stage; ``rank`` to this process's rank
    in the default process group, which must be up above one stage
    (``parallel/multihost.init_multihost``) with a world of pp ranks and
    the backend the devices call for. The point-to-point connections are
    opened here (``comm.warm_up``). The backend is printed."""
    from dynamo_tpu_torch.parallel.sharding import default_devices, join_group

    if pp < 1:
        raise ValueError(f"pp={pp} must be positive")
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else default_devices(pp))]
    if pp > len(devices):
        raise ValueError(f"pp={pp} needs {pp} devices, have {len(devices)}")
    devices = devices[:pp]
    backend = comm.choose_backend(devices)
    group = None
    if pp > 1:
        import torch.distributed as dist

        rank = join_group(pp, rank, backend, devices)
        group = dist.group.WORLD
    mesh = PPMesh(pp, 0 if rank is None else rank, tuple(devices), backend, group)
    if pp > 1:
        if backend != comm.GLOO:
            torch.cuda.set_device(mesh.device)
        comm.warm_up(mesh)
        print(f"pp mesh: stage {mesh.stage}/{pp} on {mesh.device}, hops over {backend}",
              flush=True)
    return mesh


def pp_param_specs(cfg: ModelConfig, pp: int) -> dict[str, Any]:
    """Spec pytree matching ``model.init_params``'s structure under pp, with
    the JAX function's entries and error: stacked layer leaves split axis
    0 over ``pp``; embeddings and norms replicate (stage 0 embeds, the last
    stage projects; through the exit every stage holds both)."""
    if cfg.num_layers % pp:
        raise ValueError(f"pp={pp} must divide num_layers={cfg.num_layers}")
    layers = {"attn_norm": (PP,), "mlp_norm": (PP,), "wqkv": (PP,), "wo": (PP,)}
    if cfg.attn_qkv_bias:
        layers["bqkv"] = (PP,)
    if cfg.is_moe:
        layers.update(w_router=(PP,), w_gate=(PP,), w_up=(PP,), w_down=(PP,))
    else:
        layers.update(wgu=(PP,), w_down=(PP,))
    specs: dict[str, Any] = {
        "embed": (None, None),
        "layers": layers,
        "final_norm": (None,),
        "fuse_tp": (),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, None)
    return specs


def stage_span(cfg: ModelConfig, pp: int, stage: int) -> tuple[int, int]:
    """The layers ``[lo, hi)`` stage ``stage`` of ``pp`` holds."""
    pp_param_specs(cfg, pp)  # pp divides the layers
    n = cfg.num_layers // pp
    return stage * n, (stage + 1) * n


def stage_config(cfg: ModelConfig, pp: int) -> ModelConfig:
    """The shapes one stage holds and caches: its layers (``cfg`` itself at
    pp = 1)."""
    if pp == 1:
        return cfg
    lo, hi = stage_span(cfg, pp, 0)
    return dataclasses.replace(cfg, num_layers=hi - lo)


def stage_params(params: dict, cfg: ModelConfig, mesh: PPMesh) -> dict:
    """This stage's params from a full params dict (possibly int8): its
    layers' slice of every stacked leaf, both members of an int8
    ``{w, scale}`` pair (each carries the layer axis first); the rest
    shared. A dict that holds one stage's layers already is returned as
    it is."""
    lo, hi = stage_span(cfg, mesh.pp, mesh.stage)
    w = params["layers"]["wqkv"]
    if (w["w"] if isinstance(w, dict) else w).shape[0] == hi - lo:
        return params

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        return x[lo:hi].clone()

    return {**params, "layers": {k: take(v) for k, v in params["layers"].items()}}


@dataclass
class PPPlan:
    """Host-planned microbatch schedule (static shapes: one graph per
    (T, S, n_micro) bucket combination, as the engine's buckets)."""

    n_micro: int
    tokens: np.ndarray       # [M, Tm] i32
    positions: np.ndarray    # [M, Tm] i32
    write_pages: np.ndarray  # [M, Tm] i32 (garbage page on pad rows)
    write_offs: np.ndarray   # [M, Tm] i32
    kv_lens: np.ndarray      # [M, S] i32 — per seq, through this chunk
    cu_q_lens: np.ndarray    # [M, S+1] i32 — chunk-local ragged offsets
    last_local: np.ndarray   # [M, S] i32 — chunk-local row of seq's last token
    last_mask: np.ndarray    # [M, S] bool — last token lands in this chunk


def plan_microbatches(
    tokens: np.ndarray,       # [T] i32 ragged batch (model.forward_tokens layout)
    positions: np.ndarray,    # [T] i32
    write_pages: np.ndarray,  # [T] i32
    write_offs: np.ndarray,   # [T] i32
    kv_lens: np.ndarray,      # [S] i32 — per seq, through the whole batch
    cu_q_lens: np.ndarray,    # [S+1] i32
    num_seqs: int,
    last_rows: np.ndarray,    # [S] i32 global row of each seq's last token
    n_micro: int,
    garbage_block: int,
) -> PPPlan:
    """Split a ragged token batch into ``n_micro`` equal row chunks (JAX's
    function, array for array). Sequences may straddle chunks: per-chunk
    ``kv_lens`` count each sequence's tokens only through that chunk,
    which is the chunked-prefill contract of the ragged attention."""
    T = len(tokens)
    S = len(kv_lens)
    M = max(1, int(n_micro))
    Tm = -(-T // M)
    pad = M * Tm - T

    def padded(arr, fill):
        return np.concatenate(
            [np.asarray(arr, np.int32), np.full(pad, fill, np.int32)]
        ).reshape(M, Tm)

    plan = PPPlan(
        n_micro=M,
        tokens=padded(tokens, 0),
        positions=padded(positions, 0),
        write_pages=padded(write_pages, garbage_block),
        write_offs=padded(write_offs, 0),
        kv_lens=np.ones((M, S), np.int32),
        cu_q_lens=np.zeros((M, S + 1), np.int32),
        last_local=np.zeros((M, S), np.int32),
        last_mask=np.zeros((M, S), bool),
    )
    cu = np.asarray(cu_q_lens, np.int64)
    kv = np.asarray(kv_lens, np.int64)
    for m in range(M):
        lo_c, hi_c = m * Tm, (m + 1) * Tm
        q_in_chunk = np.maximum(0, np.minimum(cu[1:], hi_c) - np.maximum(cu[:-1], lo_c))
        q_in_chunk[num_seqs:] = 0
        # kv through this chunk = total kv minus this seq's rows in later
        # chunks (a sequence's rows are its trailing tokens).
        after = np.maximum(0, cu[1:] - hi_c)
        # A sequence with no rows in this chunk gets the benign 1 (the
        # attention skips zero-length queries; it is never consumed).
        kv_through = np.where(q_in_chunk > 0, np.maximum(1, kv - after), 1)
        plan.kv_lens[m] = kv_through.astype(np.int32)
        plan.cu_q_lens[m, 1:] = np.cumsum(q_in_chunk).astype(np.int32)
        in_chunk = (last_rows >= lo_c) & (last_rows < hi_c)
        in_chunk[num_seqs:] = False
        plan.last_mask[m] = in_chunk
        plan.last_local[m] = np.where(in_chunk, last_rows - lo_c, 0).astype(np.int32)
    return plan


def pp_forward_tokens(
    params: dict,
    cache: tuple,
    mb_tokens: torch.Tensor,     # [M, Tm]
    mb_positions: torch.Tensor,  # [M, Tm]
    mb_pages: torch.Tensor,      # [M, Tm]
    mb_offs: torch.Tensor,       # [M, Tm]
    mb_kv_lens: torch.Tensor,    # [M, S]
    block_tables: torch.Tensor,  # [S, P]
    mb_cu: torch.Tensor,         # [M, S+1]
    num_seqs: torch.Tensor,      # [1]
    mb_last_local: torch.Tensor,  # [M, S]
    mb_last_mask: torch.Tensor,  # [M, S] bool
    cfg: ModelConfig,
    mesh: PPMesh,
) -> torch.Tensor:
    """The GPipe prefill over this stage's layers (``params`` and ``cache``
    are the stage's): the last-token logits ``[S, V]`` f32, the same on
    every stage (JAX's ``pp_forward_tokens``). The cache is written in
    place."""
    from dynamo_tpu_torch.engine.model import _logits, forward_layers, rms_norm

    M, Tm = mb_tokens.shape
    S = mb_kv_lens.shape[1]
    s, last = mesh.stage, mesh.stage == mesh.pp - 1
    hid = torch.zeros((S, cfg.hidden_size), dtype=torch.float32, device=mb_tokens.device)
    pending: list = []
    for m in range(M):  # round m + s
        if s == 0:
            x = params["embed"][mb_tokens[m].long()]
        else:
            x = comm.recv_prev((Tm, cfg.hidden_size), cfg.torch_dtype, mesh)
        x = forward_layers(
            x, params["layers"], cache, mb_positions[m], mb_pages[m], mb_offs[m],
            mb_kv_lens[m], block_tables, mb_cu[m], num_seqs, cfg,
        )
        if not last:
            pending.append(comm.send_next(x, mesh))
            continue
        # The last stage banks each sequence's last-token row the round
        # its microbatch drains.
        normed = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
        take = normed[mb_last_local[m].long()]
        hid = hid + torch.where(mb_last_mask[m][:, None], take.float(), 0.0)
    comm.wait_sends(pending)
    hid = comm.exit_broadcast(hid, mesh)
    return _logits(hid.to(cfg.torch_dtype), params, cfg)


def pp_decode_round(
    params: dict,
    cache: tuple,
    r: int,
    store: torch.Tensor,     # [M, Bm] each group's current token
    tables_g: torch.Tensor,  # [M, Bm, P]
    pos0_g: torch.Tensor,    # [M, Bm]
    act_g: torch.Tensor,     # [M, Bm] bool: live lanes (active and alive)
    pending: list,
    *,
    cfg: ModelConfig,
    engine: EngineConfig,
    mesh: PPMesh,
    n_steps: int,
) -> torch.Tensor | None:
    """One wavefront round on this stage (JAX's ``pp_decode_round``):
    advance work item ``r - stage`` (decode step ``idx // M`` of lane group
    ``idx % M``) through the stage's layers, receiving it from the stage
    before and sending it on (the send joins ``pending``). In a round in
    which an item drains the last stage (``r >= pp - 1``) returns its
    logits ``[Bm, V]`` f32, the same on every stage: the last stage's
    final-norm rows are broadcast and each stage's ``V/pp`` slice of the
    logits gathered; else None. Dead lanes write the garbage block; their
    positions go on advancing (``pos0 + step``), as in JAX."""
    from dynamo_tpu_torch.engine.model import forward_layers, logits_slice, rms_norm

    M, Bm = store.shape
    s, pp, h = mesh.stage, mesh.pp, cfg.hidden_size
    bs = engine.block_size
    dev = store.device
    idx = r - s
    exit_h = None
    if 0 <= idx < n_steps * M:
        g, t = idx % M, idx // M
        x = (params["embed"][store[g].long()] if s == 0
             else comm.recv_prev((Bm, h), cfg.torch_dtype, mesh))
        pos = pos0_g[g] + t
        act = act_g[g]
        table = tables_g[g]
        # A dead lane's position may run past its table; it writes the
        # garbage page whatever the gather reads.
        page_idx = torch.clamp(pos // bs, max=table.shape[1] - 1).long()
        page = torch.gather(table, 1, page_idx[:, None])[:, 0]
        x = forward_layers(
            x, params["layers"], cache, pos, torch.where(act, page, engine.garbage_block),
            pos % bs, torch.where(act, pos + 1, 1).to(torch.int32), table,
            torch.arange(Bm + 1, dtype=torch.int32, device=dev),
            torch.full((1,), Bm, dtype=torch.int32, device=dev), cfg, kernel="decode",
        )
        if s < pp - 1:
            pending.append(comm.send_next(x, mesh))
        else:
            exit_h = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if r < pp - 1:
        return None
    if exit_h is None:
        exit_h = torch.empty((Bm, h), dtype=cfg.torch_dtype, device=dev)
    exit_h = comm.exit_broadcast(exit_h, mesh)
    return comm.stage_gather(logits_slice(exit_h, params, cfg, s, pp), mesh)

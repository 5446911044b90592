"""Rank processes for the port's parallel tests on the CPU.

``RankPair`` starts processes of this file, each one rank of a mesh over
gloo (tp = 2 by default; any dp x tp mesh, a pipeline of pp stages, or
a sequence-parallel group of sp ranks),
and sends them commands; a test's module-scoped fixture holds one pool
for its file. A rank imports no jax and nothing of the JAX package: the
tests hand it numpy arrays (JAX params pytrees mapped through
``np.asarray``) and compare what it returns with the JAX side in the test
process. Each rank runs one torch thread.

Run as ``python tests/torch_tp_ranks.py RANK WORLD COORDINATOR PORT AXES``
(``AXES`` as JSON, e.g. ``{"pp": 2}``): it connects back to the test's
listener on ``PORT``, joins the process group at ``COORDINATOR`` and
serves commands until it is told to stop.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import traceback
from multiprocessing.connection import Client, Listener
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
AUTHKEY = b"torch-tp-ranks"
log = logging.getLogger("torch_tp_ranks")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class RankPair:
    """``world`` rank processes (two by default) and their command
    channels. ``axes`` names the mesh (``{"tp": world}`` by default;
    ``{"dp": 2, "tp": 2}``, ``{"pp": 4}``, ``{"sp": 2}``). ``call(name, **kwargs)`` runs
    the command on every rank at once and returns the ranks' results in
    rank order; a rank's exception is raised here with its traceback.
    ``close()`` stops and joins the ranks, terminating any that do not
    stop."""

    def __init__(self, world: int = 2, timeout: float = 60.0, axes: dict | None = None):
        self.world = world
        axes = axes or {"tp": world}
        self.procs: list[subprocess.Popen] = []
        self.conns: list = [None] * world
        listener = Listener(("127.0.0.1", 0), authkey=AUTHKEY)
        coordinator = f"127.0.0.1:{free_port()}"
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        try:
            for r in range(world):
                self.procs.append(subprocess.Popen(
                    [sys.executable, __file__, str(r), str(world), coordinator,
                     str(listener.address[1]), json.dumps(axes)], cwd=ROOT, env=env,
                ))
            accepted: list = []
            thread = threading.Thread(
                target=lambda: accepted.extend(listener.accept() for _ in range(world)),
                daemon=True,
            )
            thread.start()
            thread.join(timeout)
            if len(accepted) < world:
                raise RuntimeError(f"{len(accepted)} of {world} ranks connected in {timeout} s")
            for conn in accepted:
                self.conns[conn.recv()] = conn
        except BaseException:
            self.close()
            raise
        finally:
            listener.close()

    def call(self, name: str, timeout: float = 60.0, **kwargs) -> list:
        for conn in self.conns:
            conn.send((name, kwargs))
        out = []
        for r, conn in enumerate(self.conns):
            if not conn.poll(timeout):
                raise TimeoutError(f"rank {r} gave no answer to {name!r} in {timeout} s")
            status, value = conn.recv()
            if status != "ok":
                raise RuntimeError(f"rank {r} failed {name!r}:\n{value}")
            out.append(value)
        return out

    def close(self) -> None:
        for conn in self.conns:
            if conn is not None:
                try:
                    conn.send(None)
                except OSError:
                    pass
        for proc in self.procs:
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()


# -- the rank side -------------------------------------------------------

def prefill_operands(chunk, start_pos, block_ids, eng, bucket) -> list[np.ndarray]:
    """The ragged operands of one sequence's prefill chunk
    (``tests/model_harness.prefill_chunk``'s, for ``forward_tokens``)."""
    n, bs = len(chunk), eng.block_size
    ids = np.asarray(block_ids, np.int32)
    tokens = np.zeros(bucket, np.int32)
    tokens[:n] = chunk
    pos = np.arange(start_pos, start_pos + n, dtype=np.int32)
    positions = np.zeros(bucket, np.int32)
    positions[:n] = pos
    write_pages = np.full(bucket, eng.garbage_block, np.int32)
    write_pages[:n] = ids[pos // bs]
    write_offs = np.zeros(bucket, np.int32)
    write_offs[:n] = pos % bs
    table = np.full((1, eng.max_blocks_per_seq), eng.garbage_block, np.int32)
    table[0, : len(ids)] = ids
    return [tokens, positions, write_pages, write_offs, np.array([start_pos + n], np.int32),
            table, np.array([0, n], np.int32), np.array([1], np.int32),
            np.array([n - 1], np.int32)]


def run_forwards(params, cache, cfg, eng, prompt, chunks, blocks, decode_toks, mesh=None):
    """Prefill ``prompt`` in ``chunks`` ((start, stop, bucket) each), then
    decode ``decode_toks`` one per step in a width-2 batch (one live
    lane); returns every step's logits as numpy."""
    import torch

    from dynamo_tpu_torch.engine import model

    out = []
    for start, stop, bucket in chunks:
        ops = prefill_operands(prompt[start:stop], start, blocks, eng, bucket)
        logits = model.forward_tokens(params, cache, *map(torch.from_numpy, ops), cfg,
                                      mesh=mesh)
        out.append(logits[0].numpy())
    table = np.full((2, eng.max_blocks_per_seq), eng.garbage_block, np.int32)
    table[0, : len(blocks)] = blocks
    active = np.array([True, False])
    for step, tok in enumerate(decode_toks):
        toks = np.array([tok, 0], np.int32)
        pos = np.array([len(prompt) + step, 0], np.int32)
        logits = model.decode_tokens(params, cache, *map(torch.from_numpy,
                                                         (toks, table, pos, active)),
                                     cfg, eng, mesh=mesh)
        out.append(logits[0].numpy())
    return out


def run_requests(core, requests: list[dict], max_steps: int = 500) -> dict[str, list[int]]:
    """Every request (wire dicts) added, then steps until the engine is
    idle; returns each request's tokens."""
    from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

    streams: dict[str, list[int]] = {r["request_id"]: [] for r in requests}
    for r in requests:
        core.add_request(PreprocessedRequest.from_wire(r))
    for _ in range(max_steps):
        if not core.has_work():
            break
        for seq, out in core.step():
            streams[seq.request_id].extend(out.token_ids)
    assert not core.has_work(), "the engine did not finish its requests"
    return streams


def _remote_wire(rid: str, prompt: list[int]) -> dict:
    """A greedy remote-decode prefill request: one token, its blocks held
    for a decode side."""
    return {"model": "t", "token_ids": prompt, "request_id": rid,
            "sampling": {"temperature": 0.0}, "stop": {"max_tokens": 1, "ignore_eos": True},
            "kv_transfer_params": {"do_remote_decode": True}}


def drive(core, requests: list[dict], max_steps: int = 4000) -> tuple[dict, dict, dict]:
    """Every request (wire dicts) added at once, then steps until all have
    finished: (tokens, finish reasons, logprob entries) by request id, as
    the JAX package's ``tests/test_pp_megastep.drive``."""
    from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

    done: dict[str, list[int]] = {r["request_id"]: [] for r in requests}
    fins: dict[str, str] = {}
    lps: dict[str, list] = {r["request_id"]: [] for r in requests}
    for r in requests:
        core.add_request(PreprocessedRequest.from_wire(r))
    for _ in range(max_steps):
        for seq, out in core.step():
            done[seq.request_id].extend(out.token_ids)
            if out.logprobs:
                lps[seq.request_id].extend(out.logprobs)
            if out.finish_reason:
                fins[seq.request_id] = str(out.finish_reason)
        if len(fins) == len(requests) and not core.has_work():
            break
    return done, fins, lps


def tier_round_trip(make_core, eng, tier_eng, prompt, noise) -> dict:
    """The tier round trip: ``prompt``'s greedy stream on a plain engine
    (``make_core(eng)``), then on a tiered one (``tier_eng``) before and
    after ``noise`` (batches of prompts, each batch run at once) pushes its
    prefix off the card; the host and disk tiers' bytes of the prefix
    blocks, by hash, and the onboards."""
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    def wire(p, rid):
        return PreprocessedRequest(model="t", token_ids=list(p), request_id=rid,
                                   sampling=SamplingOptions(temperature=0.0),
                                   stop=StopConditions(max_tokens=6)).to_wire()

    ref = run_requests(make_core(eng), [wire(prompt, "ref")])["ref"]
    core = make_core(tier_eng)
    seq_a = core.add_request(PreprocessedRequest.from_wire(wire(prompt, "a")))
    while core.has_work():
        core.step()
    prefix = seq_a.prompt_hashes[: (len(prompt) - 1) // tier_eng.block_size]
    for i, batch in enumerate(noise):
        run_requests(core, [wire(p, f"n{i}-{j}") for j, p in enumerate(batch)])
    core.offload.flush()
    host = {h: core.host_pool._blocks[h].kv.tobytes() for h in prefix if h in core.host_pool}
    disk = {h: core.disk_pool.peek(h).tobytes() for h in prefix if h in core.disk_pool}
    again = run_requests(core, [wire(prompt, "b")])["b"]
    return {"ref": ref, "again": again, "host": host, "disk": disk,
            "onboards": core.host_pool.stats.onboards + core.disk_pool.stats.onboards,
            "prefix": prefix}


def unblocked(tree: dict, cfg) -> dict:
    """A numpy params tree fused for its ``fuse_tp`` laid out for tp = 1:
    the same model (the inverse of ``sharding.reblock`` on each fused
    leaf)."""
    from dynamo_tpu_torch.parallel.sharding import fused_sizes

    tp = int(tree.get("fuse_tp", 1))
    out = dict(tree, layers=dict(tree["layers"]), fuse_tp=np.int32(1))
    for name in ("wqkv", "bqkv", "wgu"):
        leaf = tree["layers"].get(name)
        if leaf is None:
            continue
        sizes = [n // tp for n in fused_sizes(name, cfg)]

        def unblock(a):
            parts = [np.split(sh, np.cumsum(sizes)[:-1], axis=-1)
                     for sh in np.split(a, tp, axis=-1)]
            return np.concatenate([np.concatenate([p[j] for p in parts], axis=-1)
                                   for j in range(len(sizes))], axis=-1)

        out["layers"][name] = ({k: unblock(v) for k, v in leaf.items()}
                               if isinstance(leaf, dict) else unblock(leaf))
    return out


def _leaves(params) -> dict:
    """A params dict's tensors as numpy, flattened to dotted names."""
    flat = {}
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in _leaves(v).items():
                flat[f"{k}.{kk}"] = vv
        elif hasattr(v, "numpy"):
            flat[k] = v.float().numpy() if v.dtype.is_floating_point else v.numpy()
        else:
            flat[k] = v
    return flat


class Rank:
    """One rank's commands (each a method), over this process's mesh: a dp x
    tp ``mesh``, a pipeline's ``pp_mesh`` or an sp group's ``sp_mesh`` (the
    others None)."""

    def __init__(self, rank: int, world: int, coordinator: str, axes: dict):
        from dynamo_tpu_torch.ops.ring_attention import sequence_parallel_mesh
        from dynamo_tpu_torch.parallel.multihost import init_multihost
        from dynamo_tpu_torch.parallel.pipeline import make_pp_mesh
        from dynamo_tpu_torch.parallel.sharding import make_mesh

        init_multihost(coordinator, world, rank)
        self.mesh = self.pp_mesh = self.sp_mesh = None
        if "pp" in axes:
            self.pp_mesh = make_pp_mesh(axes["pp"], devices=["cpu"] * world)
        elif "sp" in axes:
            self.sp_mesh = sequence_parallel_mesh(axes["sp"], devices=["cpu"] * world)
        else:
            self.mesh = make_mesh(dp=axes.get("dp", 1), tp=axes.get("tp", 1),
                                  devices=["cpu"] * world)
        self.rank = rank
        # The tp shard this rank holds (None: a whole replica or stage).
        self.shard = self.mesh.tp_rank if self.mesh is not None and self.mesh.tp > 1 else None

    def info(self) -> dict:
        import sys as _sys

        bad = [m for m in _sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dynamo_tpu")]
        mesh = self.mesh or self.pp_mesh or self.sp_mesh
        return {"rank": mesh.rank, "backend": mesh.backend, "leaked": bad}

    def forwards(self, tree, cfg, eng, prompt, chunks, blocks, decode_toks) -> list:
        from dynamo_tpu_torch.engine.convert import params_from_numpy
        from dynamo_tpu_torch.engine.model import init_cache

        params = params_from_numpy(tree, cfg, device="cpu", rank=self.shard)
        cache = init_cache(cfg, eng, "cpu", tp=self.mesh.tp)
        return run_forwards(params, cache, cfg, eng, prompt, chunks, blocks, decode_toks,
                            self.mesh)

    def core(self, cfg, eng, tree=None, seed=0, **kw):
        """This rank's EngineCore on its mesh (``tree``: numpy params)."""
        from dynamo_tpu_torch.engine.convert import params_from_numpy
        from dynamo_tpu_torch.engine.core import EngineCore

        params = None if tree is None else params_from_numpy(tree, cfg, "cpu", self.shard)
        return EngineCore(cfg, eng, params=params, seed=seed, device="cpu", mesh=self.mesh,
                          pp_mesh=self.pp_mesh, sp_mesh=self.sp_mesh, **kw)

    def engine(self, cfg, eng, requests, tree=None, seed=0, more=(), eos=()) -> dict:
        """``requests`` (then each list of ``more``, one after another) through
        this rank's EngineCore; the streams (a list of them with ``more``),
        counters and the rank's combined KV heads."""
        from dynamo_tpu_torch.parallel import comm

        comm.reset_calls()
        core = self.core(cfg, eng, tree, seed, eos_token_ids=tuple(eos))
        streams = [run_requests(core, r) for r in (requests, *more)]
        streams = streams if more else streams[0]
        st = {**core.scheduler_stats(), **core.parallel_stats()}
        keys = ("tp", "dp", "rank", "comm_backend", "collective_calls", "collectives_per_forward",
                "forwards", "mixed_steps", "p2p_calls", "pp_stages", "pp_pipe_occupancy",
                "pp_fused_dispatches", "pp_forced_single", "preemptions", "decode_iterations")
        return {"streams": streams, "stats": {k: st[k] for k in keys},
                "calls": dict(comm.calls),
                "spec": core.spec_decode_stats(), "tiers": core.tier_stats(),
                "kv_heads": core.cache[0]["kv"].shape[2]
                if isinstance(core.cache[0], dict) else core.cache[0].shape[2],
                "layers": len(core.cache)}

    def drive(self, cfg, eng, requests, tree=None, seed=0, eos=(), spans=False) -> dict:
        """``requests`` (wire dicts) through this rank's EngineCore
        (:func:`drive`): its (tokens, finish reasons, logprobs), its
        scheduler and parallel counters, the allocator's partial blocks
        left, and with ``spans`` the ``pp_stages`` of every
        ``engine_megastep`` span."""
        from dynamo_tpu_torch import tracing
        from dynamo_tpu_torch.parallel import comm

        comm.reset_calls()
        if spans:
            tracing.configure(enabled=True, sample=1.0)
            tracing.get_collector().clear()
        core = self.core(cfg, eng, tree, seed, eos_token_ids=tuple(eos))
        out = drive(core, requests)
        st = {**core.scheduler_stats(), **core.parallel_stats()}
        res = {"out": out, "stats": st, "partials": core.allocator._partials,
               "cache": [type(c).__name__ for c in core.cache]}
        if spans:
            res["spans"] = [sp.attrs["pp_stages"] for sp in tracing.get_collector().stats()
                            if sp.name == "engine_megastep"]
        return res

    def ring(self, q, k, v) -> dict:
        """The port's ``ring_attention`` of numpy ``q``, ``k``, ``v`` (whole,
        on every rank) over this rank's sp group, and the ring's calls."""
        import torch

        from dynamo_tpu_torch.ops.ring_attention import ring_attention
        from dynamo_tpu_torch.parallel import comm

        comm.reset_calls()
        out = ring_attention(*map(torch.from_numpy, (q, k, v)), self.sp_mesh)
        return {"out": out.numpy(), "calls": dict(comm.calls)}

    def sp_engine(self, cfg, eng, batches, tree=None) -> dict:
        """Each batch of ``batches`` (wire dicts) through this rank's sp
        engine, one after another: the streams of each, the prefix-cache
        gauges after each, the counters and a digest of the cache's bytes
        but the garbage page's (pad rows land there in no defined order
        on a card)."""
        import hashlib

        import torch

        from dynamo_tpu_torch.parallel import comm

        comm.reset_calls()
        core = self.core(cfg, eng, tree)
        streams, cached = [], []
        for batch in batches:
            streams.append(run_requests(core, batch))
            cached.append(core.kv_cache_stats())
        st = {**core.scheduler_stats(), **core.parallel_stats()}
        digest = hashlib.sha256()
        for layer in core.cache:
            for t in (layer.values() if isinstance(layer, dict) else (layer,)):
                digest.update(t[:-1].contiguous().view(torch.uint8).numpy().tobytes())
        return {"streams": streams, "stats": st, "calls": dict(comm.calls),
                "kv": cached, "cache_sha": digest.hexdigest()}

    def moe_mlp(self, x, lp, cfg, dispatch) -> dict:
        """The port's ``_moe_mlp`` of numpy ``x`` on this tp rank's experts of
        the numpy layer ``lp`` (the router replicated), in ``dispatch``
        mode, and its collectives."""
        import dataclasses

        import torch

        from dynamo_tpu_torch.engine import model
        from dynamo_tpu_torch.parallel import comm

        tp, r = self.mesh.tp, self.mesh.tp_rank
        E = cfg.num_experts // tp
        w = {k: torch.from_numpy(v if k == "w_router" else v[r * E : (r + 1) * E])
             for k, v in lp.items()}
        comm.reset_calls()
        out = model._moe_mlp(torch.from_numpy(x), w,
                             dataclasses.replace(cfg, moe_dispatch=dispatch), self.mesh)
        return {"out": out.numpy(), "calls": dict(comm.calls)}

    def build(self, preset, overrides) -> dict:
        """The worker's ``build_engine`` of ``preset`` on this rank's mesh:
        the engine shape it settled on and the layers and KV heads the rank
        holds."""
        from dynamo_tpu_torch.backends.torch.main import build_engine

        core, _ = build_engine(preset, overrides, device="cpu", mesh=self.mesh,
                               pp_mesh=self.pp_mesh)
        return {"prefill_buckets": core.engine.prefill_buckets,
                "decode_buckets": core.engine.decode_buckets, "layers": len(core.cache)}

    def engine_logprobs(self, cfg, eng, request, tree=None) -> list:
        """One request (a wire dict) through this rank's EngineCore: its
        logprob entries."""
        from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

        core = self.core(cfg, eng, tree)
        core.add_request(PreprocessedRequest.from_wire(request))
        out = []
        while core.has_work():
            for _, o in core.step():
                out.extend(o.logprobs or [])
        return out

    def _stage(self, tree, cfg, eng):
        """This stage's params (of numpy ``tree``) and a zeroed cache of its
        layers."""
        from dynamo_tpu_torch.engine.convert import params_from_numpy
        from dynamo_tpu_torch.engine.model import init_cache
        from dynamo_tpu_torch.parallel.pipeline import stage_config, stage_params

        params = stage_params(params_from_numpy(tree, cfg, "cpu"), cfg, self.pp_mesh)
        return params, init_cache(stage_config(cfg, self.pp_mesh.pp), eng, "cpu")

    def _pp_prefill(self, params, cache, cfg, eng, wave, n_micro):
        import torch

        from dynamo_tpu_torch.parallel.pipeline import plan_microbatches, pp_forward_tokens

        plan = plan_microbatches(
            wave["tokens"], wave["positions"], wave["write_pages"], wave["write_offs"],
            wave["kv_lens"], wave["cu_q_lens"], int(wave["num_seqs"][0]), wave["last_rows"],
            n_micro, eng.garbage_block,
        )
        t = torch.from_numpy
        return pp_forward_tokens(
            params, cache, t(plan.tokens), t(plan.positions), t(plan.write_pages),
            t(plan.write_offs), t(plan.kv_lens), t(wave["block_tables"]), t(plan.cu_q_lens),
            t(wave["num_seqs"]), t(plan.last_local), t(plan.last_mask), cfg, self.pp_mesh,
        )

    def pp_prefill(self, tree, cfg, eng, wave, n_micro) -> dict:
        """One GPipe prefill of the ragged ``wave`` in ``n_micro``
        microbatches on this stage: the logits and the stage's pages."""
        import torch

        params, cache = self._stage(tree, cfg, eng)
        logits = self._pp_prefill(params, cache, cfg, eng, wave, n_micro)
        return {"logits": logits.numpy(), "cache": torch.stack(cache).numpy()}

    def pp_decode(self, tree, cfg, eng, wave, dec) -> dict:
        """The wave's GPipe prefill (pp microbatches), then one wavefront
        decode step of ``dec`` (tokens, tables, positions, active; B lanes
        in pp groups): each group's logits as it drains, in lane order, and
        the communication calls of the decode rounds."""
        import torch

        from dynamo_tpu_torch.parallel import comm
        from dynamo_tpu_torch.parallel.pipeline import pp_decode_round

        pp = self.pp_mesh.pp
        params, cache = self._stage(tree, cfg, eng)
        self._pp_prefill(params, cache, cfg, eng, wave, pp)
        comm.reset_calls()
        g = lambda a: torch.from_numpy(a).reshape(pp, -1, *a.shape[1:])  # noqa: E731
        store, tables, pos, act = (g(dec[k]) for k in ("tokens", "tables", "positions", "active"))
        pending: list = []
        out = []
        for r in range(2 * pp - 1):
            logits = pp_decode_round(params, cache, r, store, tables, pos, act, pending,
                                     cfg=cfg, engine=eng, mesh=self.pp_mesh, n_steps=1)
            if logits is not None:
                out.append(logits)
        comm.wait_sends(pending)
        return {"logits": torch.cat(out).numpy(), "calls": dict(comm.calls)}

    def tiers(self, cfg, eng, tier_eng, prompt, noise, tree=None) -> dict:
        """:func:`tier_round_trip` on this rank's engines."""
        return tier_round_trip(lambda e: self.core(cfg, e, tree), eng, tier_eng, prompt, noise)

    def mesh_paths(self, cfg, eng) -> dict:
        """What a mesh engine once refused, served (every rank calls each):
        an embedding, a held prefill's export, its import into a second
        core and the imported pages read back for a peer, and its direct
        import into a third (each rank copying its own part) read back."""
        from dynamo_tpu_torch.runtime import wire

        core = self.core(cfg, eng)
        vec = core.embed([1, 2, 3])
        held = _remote_wire("h", list(range(5, 45)))
        run_requests(core, [held])
        descs = core.export_descriptors("h")
        hashes = [d[wire.IMP_HASH] for d in descs]
        pages = core.read_held_pages("h", 0, len(descs))
        direct = self.core(cfg, eng)
        n_direct = direct.import_blocks_direct(core, "h").imported
        core.release_held("h")
        dst = self.core(cfg, eng)
        res = dst.import_blocks([dict(d, kv=p) for d, p in zip(descs, pages)] or descs)
        return {"embed": vec, "blocks": len(descs), "pages": pages, "imported": res.imported,
                "back": dst.read_cached_pages(hashes), "direct": n_direct,
                "direct_back": direct.read_cached_pages(hashes),
                "used": [c.allocator.used_blocks for c in (core, dst, direct)]}

    def prefill_export(self, cfg, eng, req, tree=None) -> dict:
        """``req`` (a remote-decode wire dict) prefilled on this rank's core:
        its tokens, descriptors and held pages (rank 0's; ``[]`` on the
        others) and the collectives."""
        from dynamo_tpu_torch.parallel import comm

        comm.reset_calls()
        core = self.core(cfg, eng, tree)
        rid = req["request_id"]
        tokens = run_requests(core, [req])[rid]
        descs = core.export_descriptors(rid)
        pages = core.read_held_pages(rid, 0, len(descs))
        core.release_held(rid)
        return {"tokens": tokens, "descs": descs, "pages": pages, "calls": dict(comm.calls)}

    def import_decode(self, cfg, eng, blocks, req, tree=None) -> dict:
        """``blocks`` imported into a fresh core of this rank (every rank
        passes the same; only rank 0's pages are read), read back for a
        peer (rank 0's; ``[]`` on the others), a digest of the rank's own
        part of each imported page, then ``req`` decoded over them: its
        tokens and cached prompt tokens, and the collectives."""
        import hashlib

        from dynamo_tpu_torch.engine.core import _host_numpy
        from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
        from dynamo_tpu_torch.parallel import comm
        from dynamo_tpu_torch.runtime import wire

        comm.reset_calls()
        core = self.core(cfg, eng, tree)
        res = core.import_blocks(blocks)
        hashes = [b[wire.IMP_HASH] for b in blocks]
        back = core.read_cached_pages(hashes)
        mine = core._gather_pages([core.allocator._by_hash[h].block_id for h in hashes])
        digest = hashlib.sha256()
        for leaf in (mine.values() if isinstance(mine, dict) else (mine,)):
            digest.update(np.ascontiguousarray(_host_numpy(leaf)).tobytes())
        seq = core.add_request(PreprocessedRequest.from_wire(req))
        tokens = []
        while core.has_work():
            for s, out in core.step():
                if s is seq:
                    tokens.extend(out.token_ids)
        return {"imported": res.imported, "back": back, "digest": digest.hexdigest(),
                "tokens": tokens, "cached_tokens": seq.num_cached_tokens,
                "calls": dict(comm.calls)}

    def embed(self, cfg, eng, tokens, tree=None) -> dict:
        """``EngineCore.embed`` of ``tokens`` on this rank's core, and its
        collectives."""
        from dynamo_tpu_torch.parallel import comm

        core = self.core(cfg, eng, tree)
        comm.reset_calls()
        return {"embed": core.embed(tokens), "calls": dict(comm.calls)}

    def tier_pages(self, cfg, eng, tier_eng, prompt, noise) -> dict:
        """The pp counterpart of the JAX package's tier round trip of
        ``read_cached_pages``: ``prompt``'s greedy stream on a plain engine,
        then on a tiered one: its prefix's pages read for a peer on the
        device, again once ``noise`` (batches of prompts) has pushed them to
        this rank's host and disk tiers, and again after the prompt, sent
        again, onboarded them; this rank's tier bytes of each prefix block."""
        from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

        def req(p, rid):
            return {"model": "t", "token_ids": list(p), "request_id": rid,
                    "sampling": {"temperature": 0.0},
                    "stop": {"max_tokens": 6, "ignore_eos": True}}

        ref = run_requests(self.core(cfg, eng), [req(prompt, "ref")])["ref"]
        core = self.core(cfg, tier_eng)
        seq = core.add_request(PreprocessedRequest.from_wire(req(prompt, "a")))
        while core.has_work():
            core.step()
        prefix = seq.prompt_hashes[: (len(prompt) - 1) // tier_eng.block_size]
        w0 = core.read_cached_pages(prefix)
        for i, batch in enumerate(noise):
            run_requests(core, [req(p, f"n{i}-{j}") for j, p in enumerate(batch)])
        core.offload.flush()
        tier = {}
        for h in prefix:
            kv = (core.host_pool._blocks[h].kv if h in core.host_pool
                  else core.disk_pool.peek(h) if h in core.disk_pool else None)
            tier[h] = None if kv is None else kv.tobytes()
        w_tier = core.read_cached_pages(prefix)
        again = run_requests(core, [req(prompt, "b")])["b"]
        return {"ref": ref, "again": again, "prefix": prefix, "w0": w0, "w_tier": w_tier,
                "w1": core.read_cached_pages(prefix), "tier": tier,
                "geometry": core._page_geometry(),
                "onboards": core.host_pool.stats.onboards + core.disk_pool.stats.onboards}

    def load(self, path, quant=None, dtype="float32") -> dict:
        import torch

        from dynamo_tpu_torch.engine.loader import load_hf_llama

        _, params = load_hf_llama(path, dtype=getattr(torch, dtype), tp=self.mesh.tp,
                                  quant=quant, device="cpu", rank=self.shard)
        return _leaves(params)

    def lockstep(self, cfg, eng, requests, cancel_after, bad) -> dict:
        """Rank 0 is a LeaderCore whose records reach rank 1 by broadcast;
        rank 1 applies each and steps. Rank 0 adds ``requests`` and the
        rejected ``bad`` one, cancels the first request after
        ``cancel_after`` steps; both return what their steps emitted."""
        import torch.distributed as dist

        from dynamo_tpu_torch.backends.torch.multihost import (
            LeaderCore,
            apply_record,
            follower_mode,
        )
        from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

        def send(record):
            dist.broadcast_object_list([record], src=0)

        emitted: list[tuple[str, list[int], str | None]] = []
        records = 0
        if self.rank == 0:
            core = LeaderCore(cfg, eng, seed=0, device="cpu", mesh=self.mesh,
                              pp_mesh=self.pp_mesh, publish=send)
            seqs = [core.add_request(PreprocessedRequest.from_wire(r)) for r in requests[:2]]
            rejected = ""
            try:
                core.add_request(PreprocessedRequest.from_wire(bad))
            except ValueError as e:
                rejected = str(e)
            core.add_request(PreprocessedRequest.from_wire(requests[2]))
            steps = 0
            while core.has_work():
                if steps == cancel_after:
                    core.cancel_request(seqs[0])
                for seq, out in core.step():
                    emitted.append((seq.request_id, list(out.token_ids), out.finish_reason))
                steps += 1
                records += 1
            send(None)
            return {"emitted": emitted, "records": records, "rejected": rejected,
                    "counter": core._req_counter}
        core = self.core(cfg, eng)
        follower_mode(core)
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0)
            if box[0] is None:
                break
            apply_record(core, box[0])
            records += 1
            for seq, out in core.step():
                emitted.append((seq.request_id, list(out.token_ids), out.finish_reason))
        return {"emitted": emitted, "records": records, "counter": core._req_counter}


    def lockstep_transfer(self, cfg, eng, requests, held, ttl_held) -> dict:
        """Rank 0 is a LeaderCore whose records reach the other ranks by
        broadcast; they apply each and step. The leader runs ``requests``
        and the remote-decode ``held``; once ``held`` holds its blocks, a
        second thread reads them (``read_held_pages``) while the main
        thread steps the rest; then ``ttl_held`` holds its blocks past the
        engine's ``held_block_ttl_s``, and a step's snapshot expires the
        hold. The hold deadlines read a clock of this command's own
        (:func:`core_clock`), which stands still until the ``ttl_held``
        phase moves it past the TTL: how long the steps take on the host
        decides nothing, so the read's hold cannot expire while the read
        runs. Every rank returns its allocator's state and the ops of the
        records; the leader also the pages read and the release it
        journaled."""
        import torch.distributed as dist

        from dynamo_tpu_torch.backends.torch.multihost import (
            LeaderCore,
            apply_record,
            follower_mode,
        )
        from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

        def send(record):
            dist.broadcast_object_list([record], src=0)

        ops: list[str] = []
        out: dict = {}
        with core_clock() as now:
            if self.rank == 0:
                core = LeaderCore(cfg, eng, seed=0, device="cpu", mesh=self.mesh,
                                  pp_mesh=self.pp_mesh, sp_mesh=self.sp_mesh,
                                  publish=lambda r: (ops.extend(o["op"] for o in r["ops"]),
                                                     send(r)))
                for r in (*requests, held):
                    core.add_request(PreprocessedRequest.from_wire(r))
                while held["request_id"] not in core._held:
                    core.step()
                descs = core.export_descriptors(held["request_id"])
                box: list = []
                reader = threading.Thread(target=lambda: box.append(
                    core.read_held_pages(held["request_id"], 0, len(descs))))
                reader.start()
                for _ in range(4000):
                    if not (reader.is_alive() or core.has_work()):
                        break
                    core.step()
                reader.join(timeout=10)
                assert not reader.is_alive(), "the page read never completed"
                core.release_held(held["request_id"])
                core.add_request(PreprocessedRequest.from_wire(ttl_held))
                while core.has_work():
                    core.step()
                now[0] += eng.held_block_ttl_s + 0.05  # past the TTL on the core's clock
                core.step()  # its snapshot journals the expiry
                send(None)
                out = {"pages": box[0], "blocks": len(descs)}
            else:
                core = self.core(cfg, eng)
                follower_mode(core)
                while True:
                    box = [None]
                    dist.broadcast_object_list(box, src=0)
                    if box[0] is None:
                        break
                    ops.extend(o["op"] for o in box[0]["ops"])
                    apply_record(core, box[0])
                    core.step()
        a = core.allocator
        return {**out, "ops": ops, "held": sorted(core._held), "free": list(a._free),
                "inactive": list(a._inactive), "snapshot": a.snapshot()}


@contextlib.contextmanager
def core_clock():
    """``time.monotonic`` as ``dynamo_tpu_torch.engine.core`` reads it (the
    hold deadlines), replaced by a clock that stands still until the
    caller adds seconds to the yielded ``[now]``; the module's own ``time``
    comes back on exit."""
    import time
    import types

    from dynamo_tpu_torch.engine import core as core_mod

    now = [time.monotonic()]
    clock = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                     if not k.startswith("_")})
    clock.monotonic = lambda: now[0]
    core_mod.time = clock
    try:
        yield now
    finally:
        core_mod.time = time


def _serve(rank: int, world: int, coordinator: str, port: int, axes: dict) -> None:
    import torch

    torch.set_num_threads(1)
    conn = Client(("127.0.0.1", port), authkey=AUTHKEY)
    conn.send(rank)
    handler = Rank(rank, world, coordinator, axes)
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, kwargs = msg
        try:
            conn.send(("ok", getattr(handler, name)(**kwargs)))
        except Exception:
            # Logged here and sent to the test, which raises it.
            log.exception("rank %d: command %r failed", rank, name)
            conn.send(("error", traceback.format_exc()))
    from dynamo_tpu_torch.parallel.multihost import shutdown_multihost

    shutdown_multihost()


if __name__ == "__main__":
    _serve(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]),
           json.loads(sys.argv[5]))

"""Rank processes for the port's tensor-parallel tests on the CPU.

``RankPair`` starts two processes of this file, each one rank of a tp = 2
mesh over gloo, and sends them commands; a test's module-scoped fixture
holds one pair for its file. A rank imports no jax and nothing of the
JAX package: the tests hand it numpy arrays (JAX params pytrees mapped
through ``np.asarray``) and compare what it returns with the JAX side in
the test process. Each rank runs one torch thread.

Run as ``python tests/torch_tp_ranks.py RANK WORLD COORDINATOR PORT``: it
connects back to the test's listener on ``PORT``, joins the process group
at ``COORDINATOR`` and serves commands until it is told to stop.
"""

from __future__ import annotations

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
    channels. ``call(name, **kwargs)`` runs the command on every rank at
    once and returns the ranks' results in rank order; a rank's exception
    is raised here with its traceback. ``close()`` stops and joins the
    ranks, terminating any that do not stop."""

    def __init__(self, world: int = 2, timeout: float = 60.0):
        self.world = world
        self.procs: list[subprocess.Popen] = []
        self.conns: list = [None] * world
        listener = Listener(("127.0.0.1", 0), authkey=AUTHKEY)
        coordinator = f"127.0.0.1:{free_port()}"
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        try:
            for r in range(world):
                self.procs.append(subprocess.Popen(
                    [sys.executable, __file__, str(r), str(world), coordinator,
                     str(listener.address[1])], cwd=ROOT, env=env,
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
    """One rank's commands (each a method), over this process's mesh."""

    def __init__(self, rank: int, world: int, coordinator: str):
        from dynamo_tpu_torch.parallel.multihost import init_multihost
        from dynamo_tpu_torch.parallel.sharding import make_mesh

        init_multihost(coordinator, world, rank)
        self.mesh = make_mesh(tp=world, devices=["cpu"] * world)
        self.rank = rank

    def info(self) -> dict:
        import sys as _sys

        bad = [m for m in _sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dynamo_tpu")]
        return {"rank": self.mesh.rank, "backend": self.mesh.backend, "leaked": bad}

    def forwards(self, tree, cfg, eng, prompt, chunks, blocks, decode_toks) -> list:
        from dynamo_tpu_torch.engine.convert import params_from_numpy
        from dynamo_tpu_torch.engine.model import init_cache

        params = params_from_numpy(tree, cfg, device="cpu", rank=self.rank)
        cache = init_cache(cfg, eng, "cpu", tp=self.mesh.tp)
        return run_forwards(params, cache, cfg, eng, prompt, chunks, blocks, decode_toks,
                            self.mesh)

    def engine(self, cfg, eng, requests, tree=None, seed=0, more=()) -> dict:
        """``requests`` (then each list of ``more``, one after another) through
        this rank's EngineCore; the streams (a list of them with ``more``),
        counters and the rank's combined KV heads."""
        from dynamo_tpu_torch.engine.convert import params_from_numpy
        from dynamo_tpu_torch.engine.core import EngineCore
        from dynamo_tpu_torch.parallel import comm

        params = None if tree is None else params_from_numpy(tree, cfg, "cpu", self.rank)
        comm.reset_calls()
        core = EngineCore(cfg, eng, params=params, seed=seed, device="cpu", mesh=self.mesh)
        streams = [run_requests(core, r) for r in (requests, *more)]
        streams = streams if more else streams[0]
        st = {**core.scheduler_stats(), **core.parallel_stats()}
        keys = ("tp", "rank", "comm_backend", "collective_calls", "collectives_per_forward",
                "forwards", "mixed_steps")
        return {"streams": streams, "stats": {k: st[k] for k in keys},
                "spec": core.spec_decode_stats(), "tiers": core.tier_stats(),
                "kv_heads": core.cache[0]["kv"].shape[2]
                if isinstance(core.cache[0], dict) else core.cache[0].shape[2]}

    def refusals(self, cfg, eng) -> list[str]:
        """The message of each path a tp = 2 engine refuses (ROADMAP.md
        A12d): embeddings, block export and import, serving cached pages."""
        from dynamo_tpu_torch.engine.core import EngineCore

        core = EngineCore(cfg, eng, seed=0, device="cpu", mesh=self.mesh)
        out = []
        for call in (lambda: core.embed([1, 2, 3]), lambda: core.export_descriptors("r"),
                     lambda: core.read_held_pages("r", 0, 1), lambda: core.import_blocks([]),
                     lambda: core.read_cached_pages([1])):
            try:
                call()
                out.append("")
            except ValueError as e:
                out.append(str(e))
        return out

    def load(self, path, quant=None, dtype="float32") -> dict:
        import torch

        from dynamo_tpu_torch.engine.loader import load_hf_llama

        _, params = load_hf_llama(path, dtype=getattr(torch, dtype), tp=self.mesh.tp,
                                  quant=quant, device="cpu", rank=self.rank)
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
        from dynamo_tpu_torch.engine.core import EngineCore
        from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

        def send(record):
            dist.broadcast_object_list([record], src=0)

        emitted: list[tuple[str, list[int], str | None]] = []
        records = 0
        if self.rank == 0:
            core = LeaderCore(cfg, eng, seed=0, device="cpu", mesh=self.mesh, publish=send)
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
        core = EngineCore(cfg, eng, seed=0, device="cpu", mesh=self.mesh)
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


def _serve(rank: int, world: int, coordinator: str, port: int) -> None:
    import torch

    torch.set_num_threads(1)
    conn = Client(("127.0.0.1", port), authkey=AUTHKEY)
    conn.send(rank)
    handler = Rank(rank, world, coordinator)
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
    _serve(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))

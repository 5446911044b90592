"""Where the time goes on the card: the llama3-8b main path, traced.

Run from the repository root on a machine with one CUDA card::

    python3 -m dynamo_tpu_torch.tools.profile_serving [--int8] [--traces DIR]

Builds ``build_engine("llama3-8b")`` (random weights, default
``EngineConfig``; with ``--int8`` int8 weights and int8 KV pages, the
capacity mode) and first times the attention wrapper's host cost per call
at the serving decode shape with trivial device work (8 rows that see one
position each, bf16 pages); with CUDA graphs the engine pays it only at
capture. Then, for synchronous and then asynchronous execution (a second
engine on the same weights), it runs ``warm_up()`` (which captures the
engine's CUDA graphs) and one short request, then seven prompts
(100–2000 tokens, greedy, 64 new tokens each) through ``EngineCore.step``
twice. The first batch runs untraced: the prefill wave's wall time and
each decode step's wall time per iteration (k = 8 at width 8); sync steps
are each followed by a device sync, async steps are not (each step
dispatches a megastep and commits the one before). The second batch (new
prompts of the same lengths) traces two phases with ``torch.profiler``:
the prefill wave, and the next two decode steps, each phase ended by a
device sync. For each it prints the host wall time, the device time from
CUDA events, the summed kernel time by group (attention kernel, matrix
products, everything else; the attention kernel also by its kernels:
split-KV decode, combine, tiled), the device's idle share (1 - kernel
time / wall time) and the top kernels; kernels that run inside a graph
replay are recorded one by one, as eager launches are. ``--traces`` also
writes each phase's Chrome trace there.

The script uses only the package's entry points, so it also measures
another checkout's package, for a parent-against-change A/B in one call
(parent, change, change, parent)::

    PYTHONPATH=<other checkout> python3 dynamo_tpu_torch/tools/profile_serving.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PROMPT_LENS = (2000, 1124, 100, 700, 1500, 300, 1800)


def _group(name: str) -> str:
    if "ragged_paged_attention" in name:
        return "attention"
    low = name.lower()
    if any(k in low for k in ("gemm", "cutlass", "sm90_xmma", "cublas", "nvjet")):
        return "matmul"
    return "other"


def _phase(core, n_steps: int, name: str, trace_dir: Path | None) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        for _ in range(n_steps):
            core.step()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_dir is not None:
        prof.export_chrome_trace(str(trace_dir / f"{name}.json"))
    # Device-side kernel records only: an operator's row (aten::mm, ...)
    # repeats the device time of the kernels it launched.
    kernels = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    groups: dict[str, float] = {}
    attention: dict[str, list] = {}  # K1 by kernel: [ms, launches]
    for key, ms, calls in kernels:
        groups[_group(key)] = groups.get(_group(key), 0.0) + ms
        if _group(key) == "attention":
            part = next((k for k in ("decode", "combine", "tiled") if f"_{k}_kernel" in key), key)
            got = attention.setdefault(part, [0.0, 0])
            got[0] += ms
            got[1] += calls
    busy = sum(groups.values())
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {
        "phase": name, "steps": n_steps, "wall_ms": wall_ms,
        "device_event_ms": start.elapsed_time(end), "kernel_ms": busy,
        "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
        "groups_ms": groups,
        "attention_by_kernel": {k: {"ms": v[0], "launches": v[1]} for k, v in attention.items()},
        "top": [{"kernel": k[:90], "ms": ms, "calls": c} for k, ms, c in top],
    }


def wrapper_host_us(reps: int = 500, rounds: int = 5) -> list[float]:
    """The attention wrapper's host cost per call, ``rounds`` means of
    ``reps`` back-to-back calls at the serving decode shape (T == S == 8,
    pages_per_seq 256, 2049 pages of 32) where each row sees one position,
    so the device keeps up and the host sets the pace."""
    from dynamo_tpu_torch.ops.ragged_attention import ragged_paged_attention

    dev = "cuda"
    q = torch.randn(8, 32, 128, device=dev).bfloat16()
    kv = torch.randn(2049, 32, 16, 128, device=dev).bfloat16()
    lens = torch.ones(8, dtype=torch.int32, device=dev)
    tables = (torch.arange(8 * 256, dtype=torch.int32, device=dev) % 2048).reshape(8, 256)
    cu = torch.arange(9, dtype=torch.int32, device=dev)
    ns = torch.tensor([8], dtype=torch.int32, device=dev)
    call = lambda: ragged_paged_attention(q, kv, lens, tables, cu, ns, sm_scale=128 ** -0.5)  # noqa: E731
    for _ in range(50):
        call()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        out.append((time.perf_counter() - t0) * 1e6 / reps)
        torch.cuda.synchronize()
    return out


def untraced_walls(core) -> dict:
    """Run the queued batch to its end untraced: the first step's wall
    time (a sync engine's prefill wave; an async engine only dispatches
    it) and each full decode step's wall time per iteration. A sync
    engine's steps each end in a device sync; an async engine's steps are
    timed as the loop runs them (each lands the step before)."""
    k = core.engine.megastep
    sync = not core.engine.async_exec
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    core.step()
    if sync:
        torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    per_iter = []
    while core.has_work():
        t0 = time.perf_counter()
        core.step()
        if sync:
            torch.cuda.synchronize()
        per_iter.append((time.perf_counter() - t0) * 1e3 / k)
    full = per_iter[1:-2]  # the first lands the prefill (async); the last may run < k
    return {"prefill_wave_ms": prefill_ms, "decode_ms_per_iteration": full,
            "decode_median_ms_per_iteration": float(np.median(full))}


def profile_mode(core, request, trace_dir: Path | None, tag: str) -> dict:
    """Warm ``core`` up (capturing its graphs), then the untraced batch and
    the two traced phases."""
    t0 = time.perf_counter()
    core.warm_up()
    torch.cuda.synchronize()
    warm = {"warm_up_s": time.perf_counter() - t0,
            "graph_captures": core.scheduler_stats()["graph_captures"]}
    core.add_request(request("warmup", 600, 16))  # one request through the graphs
    while core.has_work():
        core.step()
    for i, n in enumerate(PROMPT_LENS):
        core.add_request(request(f"u{i}", n, 64))
    walls = untraced_walls(core)
    print(json.dumps({"mode": tag, "warm_up": warm, "untraced": walls}), flush=True)
    for i, n in enumerate(PROMPT_LENS):
        core.add_request(request(f"r{i}", n, 64))
    phases = [
        _phase(core, 1, f"prefill_wave_{tag}", trace_dir),
        _phase(core, 2, f"decode_megasteps_{tag}", trace_dir),
    ]
    for p in phases:
        print(json.dumps(p), flush=True)
    while core.has_work():
        core.step()
    st = core.scheduler_stats()
    return {"mode": tag, "warm_up": warm, "untraced": walls, "graph_replays": st["graph_replays"],
            "dispatches": st["dispatches"], "phases": [
                {k: p[k] for k in ("phase", "wall_ms", "kernel_ms", "idle_share", "groups_ms",
                                   "attention_by_kernel")}
                for p in phases]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=Path, default=None, help="write Chrome traces here")
    ap.add_argument("--int8", action="store_true", help="int8 weights and int8 KV pages")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA card", file=sys.stderr)
        return 2
    import dynamo_tpu_torch
    from dynamo_tpu_torch.backends.torch.main import build_engine
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )

    if args.traces is not None:
        args.traces.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    host_us = wrapper_host_us()
    print(f"attention wrapper host us per call (serving decode shape): "
          + " ".join(f"{x:.1f}" for x in host_us), flush=True)
    overrides = {"kv_dtype": "int8"} if args.int8 else {}
    core, _ = build_engine("llama3-8b", overrides, seed=0, device="cuda",
                           quant="int8" if args.int8 else None)
    rng = np.random.default_rng(7)
    vocab = core.cfg.vocab_size

    def request(rid, n, max_tokens):
        return PreprocessedRequest(
            model="llama3-8b", request_id=rid,
            token_ids=[int(t) for t in rng.integers(0, vocab, n)],
            sampling=SamplingOptions(temperature=0.0),
            stop=StopConditions(max_tokens=max_tokens),
        )

    modes = [profile_mode(core, request, args.traces, "sync")]
    acore, _ = build_engine("llama3-8b", {**overrides, "async_exec": True}, device="cuda",
                            params=core.params)
    del core
    torch.cuda.empty_cache()
    modes.append(profile_mode(acore, request, args.traces, "async"))
    print(json.dumps({"card": card, "int8": args.int8, "package": dynamo_tpu_torch.__file__,
                      "wrapper_host_us": host_us, "modes": modes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

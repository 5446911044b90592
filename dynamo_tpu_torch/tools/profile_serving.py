"""Where the time goes on the card: the llama3-8b main path, traced.

Run from the repository root on a machine with one CUDA card::

    python3 -m dynamo_tpu_torch.tools.profile_serving [--int8] [--traces DIR]
        [--scheduling chunked] [--spec-decode ngram [--spec-device-draft]]

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

With ``--scheduling chunked`` it traces chunked scheduling instead: one
mixed step (an engine at megastep k = 1) and one fused megastep (k = 8),
each with the seven prompts decoding and a 2124-token prompt arriving, so
the traced step puts its first 2048-token chunk next to seven decode rows
(token bucket 8192, width 8): each engine runs ``warm_up()``, the batch
runs untraced until every prompt decodes, then the one step is traced as
above (host wall, kernel time by group, K1 by kernel, idle share).

With ``--spec-decode ngram`` it traces speculative decoding instead: an
engine at the defaults with ``spec_k`` 4 (and, with
``--spec-device-draft``, drafting allowed on the card) runs ``warm_up()``
(its graph keys by kind and its seconds), then eight prompts that each
quote a random segment several times (six greedy, two seeded, as in
``chip_smoke.py``'s speculation phase; 64 new tokens) until every one
decodes, and traces one step: the first megastep whose verify rows
carry host drafts (the requests turn device drafting off), and with
``--spec-device-draft`` a second batch's first drafting megastep, each as
above plus the step's speculation counters.

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
LONG_PROMPT = 2124  # arrives while PROMPT_LENS decode (--scheduling chunked)


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


def chunked_step(core, request, trace_dir: Path | None, tag: str) -> dict:
    """Warm ``core`` (chunked scheduling) up, run the batch untraced until
    every prompt decodes, then trace the one step that takes the long
    prompt's first chunk beside the decode rows."""
    t0 = time.perf_counter()
    core.warm_up()
    torch.cuda.synchronize()
    warm = {"warm_up_s": time.perf_counter() - t0,
            "graph_captures": core.scheduler_stats()["graph_captures"]}
    for i, n in enumerate(PROMPT_LENS):
        core.add_request(request(f"{tag}{i}", n, 64))
    while not (len(core.running) == len(PROMPT_LENS)
               and all(s.prefill_done for s in core.running)):
        core.step()
    core.add_request(request(f"{tag}_long", LONG_PROMPT, 8))
    before = core.scheduler_stats()
    phase = _phase(core, 1, tag, trace_dir)
    st = core.scheduler_stats()
    phase.update({k: st[k] - before[k] for k in (
        "mixed_tokens", "mixed_bucket_tokens", "forwards", "fused_mixed_dispatches")})
    print(json.dumps(phase), flush=True)
    while core.has_work():
        core.step()
    return {"mode": tag, "warm_up": warm, "phase": {
        k: phase[k] for k in ("phase", "wall_ms", "kernel_ms", "idle_share", "groups_ms",
                              "attention_by_kernel", "mixed_tokens", "mixed_bucket_tokens",
                              "forwards", "fused_mixed_dispatches")}}


SPEC_SEGMENTS = ((48, 6), (56, 5), (64, 4), (72, 4), (80, 3), (96, 3), (120, 2), (160, 2))
SPEC_SEEDED = {6: (0.7, 31), 7: (0.9, 32)}  # lane: (temperature, seed)


def spec_step(core, request, trace_dir: Path | None, tag: str, device: bool) -> dict:
    """Run eight segment-quoting prompts until every one decodes, then
    trace single steps until one carries drafts (``device``: until one is
    a drafting megastep), at most 16; report the traced step with its
    speculation counters."""
    spec = {"method": "ngram", "device": device}
    for i, n in enumerate(SPEC_SEGMENTS):
        core.add_request(request(f"{tag}{i}", n, 64, spec, *SPEC_SEEDED.get(i, (0.0, None))))
    while not (len(core.running) == len(SPEC_SEGMENTS)
               and all(s.prefill_done and s.pending is not None for s in core.running)):
        core.step()
    keys = ("drafted_tokens", "accepted_tokens", "verify_rows", "device_rounds", "device_hits")
    for _ in range(16):
        before, sbefore = core.scheduler_stats(), core.spec_decode_stats()
        phase = _phase(core, 1, tag, trace_dir)
        st, sst = core.scheduler_stats(), core.spec_decode_stats()
        phase.update({k: st[k] - before[k] for k in ("forwards", "committed_tokens",
                                                     "megastep_dispatches", "dispatches")})
        phase.update({k: sst[k] - sbefore[k] for k in keys})
        if phase["device_rounds" if device else "drafted_tokens"] > 0:
            break
    else:
        raise AssertionError(f"{tag}: no step in 16 carried {'device rounds' if device else 'drafts'}")
    print(json.dumps(phase), flush=True)
    while core.has_work():
        core.step()
    return {"mode": tag, "phase": {k: phase[k] for k in (
        "phase", "wall_ms", "kernel_ms", "idle_share", "groups_ms", "attention_by_kernel",
        "forwards", "committed_tokens", *keys)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=Path, default=None, help="write Chrome traces here")
    ap.add_argument("--int8", action="store_true", help="int8 weights and int8 KV pages")
    ap.add_argument("--scheduling", default="waves", choices=["waves", "chunked"],
                    help="waves: a prefill wave and decode megasteps, sync and async; "
                         "chunked: one mixed step and one fused megastep")
    ap.add_argument("--spec-decode", default="off", choices=["off", "ngram"],
                    help="ngram: trace a verify megastep (host drafts) instead")
    ap.add_argument("--spec-device-draft", action="store_true",
                    help="with --spec-decode ngram: also trace a drafting megastep")
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

    def request(rid, n, max_tokens, spec=None, temperature=0.0, seed=None):
        # With spec, n is (segment length, repeats): a quoting prompt.
        if spec is None:
            ids = [int(t) for t in rng.integers(0, vocab, n)]
        else:
            ids = [int(t) for t in rng.integers(0, vocab, n[0])] * n[1]
        return PreprocessedRequest(
            model="llama3-8b", request_id=rid, token_ids=ids,
            sampling=SamplingOptions(temperature=temperature, seed=seed),
            stop=StopConditions(max_tokens=max_tokens), spec_decode=spec,
        )

    if args.spec_decode == "ngram":
        scfg = {**overrides, "spec_decode": "ngram", "spec_k": 4,
                "spec_device_draft": args.spec_device_draft}
        score, _ = build_engine("llama3-8b", scfg, device="cuda", params=core.params)
        del core
        torch.cuda.empty_cache()
        launches = score._warm_up_launches()
        kinds = [launch.key[0] for launch, _ in launches]
        t0 = time.perf_counter()
        score.warm_up()
        torch.cuda.synchronize()
        st = score.scheduler_stats()
        warm = {"warm_up_s": time.perf_counter() - t0, "graph_captures": st["graph_captures"],
                "graph_capture_s": st["graph_capture_s"],
                "keys": {k: kinds.count(k) for k in sorted(set(kinds))}}
        print(json.dumps({"spec_warm_up": warm}), flush=True)
        modes = [{"warm_up": warm}, spec_step(score, request, args.traces, "verify_megastep", False)]
        if args.spec_device_draft:
            modes.append(spec_step(score, request, args.traces, "drafting_megastep", True))
    elif args.scheduling == "chunked":
        modes = []
        for k, tag in ((1, "mixed_step_chunked"), (8, "fused_megastep_chunked")):
            ccore, _ = build_engine("llama3-8b", {**overrides, "scheduling": "chunked",
                                                  "megastep_k": k},
                                    device="cuda", params=core.params)
            modes.append(chunked_step(ccore, request, args.traces, tag))
            del ccore
            torch.cuda.empty_cache()
    else:
        modes = [profile_mode(core, request, args.traces, "sync")]
        acore, _ = build_engine("llama3-8b", {**overrides, "async_exec": True}, device="cuda",
                                params=core.params)
        del core
        torch.cuda.empty_cache()
        modes.append(profile_mode(acore, request, args.traces, "async"))
    print(json.dumps({"card": card, "int8": args.int8, "scheduling": args.scheduling,
                      "spec_decode": args.spec_decode, "spec_device_draft": args.spec_device_draft,
                      "package": dynamo_tpu_torch.__file__,
                      "wrapper_host_us": host_us, "modes": modes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

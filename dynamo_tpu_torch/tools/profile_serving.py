"""Where the time goes on the card: the llama3-8b main path, traced.

Run from the repository root on a machine with one CUDA card::

    python3 -m dynamo_tpu_torch.tools.profile_serving [--int8] [--traces DIR]

Builds ``build_engine("llama3-8b")`` (random weights, default
``EngineConfig``; with ``--int8`` int8 weights and int8 KV pages, the
capacity mode), warms it up with one short request, then runs seven
prompts (100–2000 tokens, greedy, 64 new tokens each) through
``EngineCore.step`` and traces two phases with ``torch.profiler``: the
prefill wave, and the first two decode megasteps (k = 8 at width 8). For
each phase it prints the host wall time (every step ends in the
device-to-host copy of its tokens, so wall time covers the device work),
the device time from CUDA events, the summed kernel time by group
(attention kernel, matrix products, everything else), the device's idle
share (1 - kernel time / wall time) and the top kernels. ``--traces``
also writes each phase's Chrome trace there (the decode phase's is ~60 MB).
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
    for key, ms, _ in kernels:
        groups[_group(key)] = groups.get(_group(key), 0.0) + ms
    busy = sum(groups.values())
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {
        "phase": name, "steps": n_steps, "wall_ms": wall_ms,
        "device_event_ms": start.elapsed_time(end), "kernel_ms": busy,
        "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
        "groups_ms": groups,
        "top": [{"kernel": k[:90], "ms": ms, "calls": c} for k, ms, c in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=Path, default=None, help="write Chrome traces here")
    ap.add_argument("--int8", action="store_true", help="int8 weights and int8 KV pages")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA card", file=sys.stderr)
        return 2
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
    if args.int8:
        core, _ = build_engine("llama3-8b", {"kv_dtype": "int8"}, seed=0, device="cuda", quant="int8")
    else:
        core, _ = build_engine("llama3-8b", seed=0, device="cuda")
    rng = np.random.default_rng(7)

    def request(rid, n, max_tokens):
        return PreprocessedRequest(
            model="llama3-8b", request_id=rid,
            token_ids=[int(t) for t in rng.integers(0, core.cfg.vocab_size, n)],
            sampling=SamplingOptions(temperature=0.0),
            stop=StopConditions(max_tokens=max_tokens),
        )

    core.add_request(request("warmup", 600, 16))  # cuBLAS/allocator warm-up
    while core.has_work():
        core.step()
    for i, n in enumerate(PROMPT_LENS):
        core.add_request(request(f"r{i}", n, 64))
    phases = [
        _phase(core, 1, "prefill_wave", args.traces),
        _phase(core, 2, "decode_megasteps", args.traces),
    ]
    for p in phases:
        print(json.dumps(p), flush=True)
    while core.has_work():
        core.step()
    print(json.dumps({"card": card, "int8": args.int8, "phases": [
        {k: p[k] for k in ("phase", "wall_ms", "kernel_ms", "idle_share", "groups_ms")}
        for p in phases
    ]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

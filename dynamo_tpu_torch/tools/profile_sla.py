"""SLA profiler: sweep the port's engine on one card and write the planner's
performance profile.

Counterpart of the JAX package's ``benchmarks/profile_sla.py``, with its
sweeps, flags and output, on ``dynamo_tpu_torch``'s ``EngineCore``:

- prefill: time to first token against input length, one request at a
  time (the best of two runs after one that warms the bucket), and
- decode: inter-token latency against concurrency at a fixed context (the
  median over the requests of their time per token after the first),

then write exactly the dict ``planner.perf_interpolation.from_profile``
loads (the port's and the JAX package's alike), so ``Planner`` plans from
measured numbers.

Usage::

    python -m dynamo_tpu_torch.tools.profile_sla --preset llama3-1b --out profile.json
    python -m dynamo_tpu_torch.tools.profile_sla --preset tiny --quick --device cpu

``--device cuda`` (the default) runs the card's kernels and needs a card;
``--device cpu`` the plain versions. On the card a model K1 cannot run is
refused before a sweep starts, as every engine refuses it (the ``tiny``
presets are f32). The JAX profiler builds an engine per concurrency point;
this one builds one per distinct ``EngineConfig`` and reuses it, which
gives the same counts: up to 8 concurrent requests every point's config is
the same (8 slots, decode width 8, the same block count), and each point's
requests finish and free their blocks before the next point starts.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _drain_one(core, seq) -> float:
    """Run until ``seq`` finishes; returns its time to first token (s)."""
    t0 = time.perf_counter()
    first = None
    while seq.finish is None:
        for s, out in core.step():
            if s is seq and out.token_ids and first is None:
                first = time.perf_counter() - t0
    return first


def profile_prefill(make_core, isl_grid: list[int], reps: int = 2) -> dict:
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    core = make_core(max(isl_grid))
    rng = np.random.RandomState(0)
    vocab = core.cfg.vocab_size
    ttfts: list[float] = []
    for isl in isl_grid:
        best = float("inf")
        for r in range(reps + 1):  # the first run warms the bucket (a graph's capture)
            seq = core.add_request(
                PreprocessedRequest(
                    model="profile",
                    token_ids=rng.randint(1, vocab, size=isl).tolist(),
                    request_id=f"pf-{isl}-{r}",
                    sampling=SamplingOptions(temperature=0.0),
                    stop=StopConditions(max_tokens=1, ignore_eos=True),
                )
            )
            ttft = _drain_one(core, seq)
            if r > 0:
                best = min(best, ttft)
        ttfts.append(round(best, 5))
    return {"isl": list(map(float, isl_grid)), "ttft_s": ttfts}


def profile_decode(make_core, concurrency_grid: list[int], ctx: int = 128, osl: int = 32) -> dict:
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    rng = np.random.RandomState(1)
    itls: list[float] = []
    for conc in concurrency_grid:
        core = make_core(ctx, batch=conc)
        vocab = core.cfg.vocab_size

        def req(i, n_out):
            return PreprocessedRequest(
                model="profile",
                token_ids=rng.randint(1, vocab, size=ctx).tolist(),
                request_id=f"dc-{conc}-{i}",
                sampling=SamplingOptions(temperature=0.0),
                stop=StopConditions(max_tokens=n_out, ignore_eos=True),
            )

        # Warm the decode path (a megastep of the resolved length).
        _drain_one(core, core.add_request(req("w", core.engine.megastep)))

        seqs = [core.add_request(req(i, osl)) for i in range(conc)]
        first: dict[str, float] = {}
        last: dict[str, float] = {}
        counts: dict[str, int] = {}
        done = 0
        t0 = time.perf_counter()
        while done < len(seqs):
            for s, out in core.step():
                now = time.perf_counter() - t0
                rid = s.request_id
                first.setdefault(rid, now)
                last[rid] = now
                counts[rid] = counts.get(rid, 0) + len(out.token_ids)
                if out.finish_reason:
                    done += 1
        per_tok = [(last[r] - first[r]) / (counts[r] - 1) for r in first if counts[r] > 1]
        itls.append(round(float(np.median(per_tok)), 5))
    return {"concurrency": list(map(float, concurrency_grid)), "itl_s": itls}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="dynamo-tpu SLA profiler (PyTorch port)")
    ap.add_argument("--preset", default="llama3-1b")
    ap.add_argument("--out", default="profile.json")
    ap.add_argument("--quick", action="store_true", help="small grids (CI/CPU)")
    ap.add_argument("--isl-grid", type=int, nargs="*", default=None)
    ap.add_argument("--concurrency-grid", type=int, nargs="*", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card's kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    import torch

    from dynamo_tpu_torch.engine.config import PRESETS, EngineConfig
    from dynamo_tpu_torch.engine.core import EngineCore, check_slice, resolve_device

    device = resolve_device(args.device)
    cfg = PRESETS[args.preset]()
    check_slice(cfg, EngineConfig(), device)  # a model K1 cannot run, before any engine
    tiny = cfg.hidden_size <= 256
    if args.quick or tiny:
        isl_grid = args.isl_grid or [16, 32, 64]
        conc_grid = args.concurrency_grid or [1, 4]
        ctx, osl = 32, 8
    else:
        isl_grid = args.isl_grid or [128, 512, 2048]
        conc_grid = args.concurrency_grid or [1, 8, 32, 64]
        ctx, osl = 128, 32

    engines: dict[EngineConfig, EngineCore] = {}

    def make_core(max_len: int, batch: int = 8) -> EngineCore:
        bs = 8 if tiny else 32
        bucket = max(64, 1 << (max_len - 1).bit_length())
        blocks = max(64, (batch + 2) * -(-(max_len + osl) // bs))
        eng = EngineConfig(
            num_kv_blocks=blocks,
            block_size=bs,
            max_num_seqs=max(batch, 8),
            max_model_len=bucket + 2 * osl + bs,
            prefill_buckets=(bucket,),
            prefill_batch=min(16, max(batch, 8)),
            decode_buckets=(max(batch, 8),),
            decode_chain=min(32, osl),
        )
        if eng not in engines:
            engines.clear()  # one engine on the device at a time
            engines[eng] = EngineCore(cfg, eng, seed=0, device=device)
        return engines[eng]

    t0 = time.perf_counter()
    profile = {
        "meta": {"preset": args.preset, "ctx": ctx, "osl": osl, "device": device.type,
                 "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                 else "cpu")},
        "prefill": profile_prefill(make_core, isl_grid),
        "decode": profile_decode(make_core, conc_grid, ctx=ctx, osl=osl),
    }
    profile["meta"]["sweep_s"] = round(time.perf_counter() - t0, 3)
    engines.clear()
    with open(args.out, "w") as f:
        json.dump(profile, f, indent=1)
    print(json.dumps(profile), flush=True)
    return profile


if __name__ == "__main__":
    main()

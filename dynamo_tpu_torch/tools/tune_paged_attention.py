"""K2 (``csrc/paged_attention.cu``) on the card: what the compiler made of
it, how its time moves with the split plan and the ring depth, and the
wrapper's host cost per call.

Run from the repository root on a machine with one CUDA card::

    python3 -m dynamo_tpu_torch.tools.tune_paged_attention [--stages 2 3 4 6]

It (1) builds the source once with ``-Xptxas -v`` and prints each
instance's registers, spills and shared memory, (2) builds one copy of the
source per ring depth in ``--stages`` (all nvcc runs started together),
(3) runs K2's three checked shapes (``chip_smoke.py``'s ``k2_cases``: the
int8-against-bf16 comparison's, decode8 and decode64), bf16 and int8
pages, no self position, at every split count that some plan of
``--split-positions`` (positions a split aims at) and
``--max-blocks-per-sm`` gives, and at one split,
holding each run to the plain version (largest relative L2 error of an
output vector, at most 1e-2) and timing it with the L2 flushed (mean of
``--reps`` after a warm-up), and (4) prints the wrapper's host µs per call.
The last line is one JSON object with every number.

``--host-us-only`` runs step (4) alone through ``paged_attention``, the
one entry point every version of the package has, so the script also
measures another checkout's package, for a parent-against-change A/B in
one call (parent, change, change, parent)::

    PYTHONPATH=<other checkout> python3 dynamo_tpu_torch/tools/tune_paged_attention.py --host-us-only
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HEAD_DIM = 128
ROW_REL_TOL = 1e-2


def cases():
    """chip_smoke.py's k2_cases: (name, B, n_kv, group, block_size,
    max_blocks, seq_lens, q dtype)."""
    rng = np.random.default_rng(2)
    return [
        ("bench_kvquant", 16, 8, 4, 32, 8, [251] * 16, torch.float32),
        ("decode8", 8, 8, 4, 32, 128, [4096, 3000, 2048, 1500, 1024, 700, 300, 33], torch.bfloat16),
        ("decode64", 64, 8, 4, 32, 128, [int(x) for x in rng.integers(1, 4097, 64)], torch.bfloat16),
    ]


def operands(B, n_kv, group, bs, max_blocks, lens, q_dtype, gen, int8):
    from dynamo_tpu_torch.engine.kv_quant import quantize_kv

    dev = "cuda"
    total = (B * max_blocks + 1) * bs
    q = torch.randn(B, n_kv * group, HEAD_DIM, device=dev, generator=gen).to(q_dtype)
    k = torch.randn(n_kv, total, HEAD_DIM, device=dev, generator=gen).bfloat16()
    v = torch.randn(n_kv, total, HEAD_DIM, device=dev, generator=gen).bfloat16()
    tables = torch.randperm(B * max_blocks, device=dev, generator=gen).to(torch.int32)
    args = (q, k, v, tables.reshape(B, max_blocks).contiguous(),
            torch.tensor(lens, dtype=torch.int32, device=dev))
    kw = {"block_size": bs}
    if int8:
        (k8, kw["k_scale"]), (v8, kw["v_scale"]) = quantize_kv(k), quantize_kv(v)
        args = (q, k8, v8, *args[3:])
    return args, kw


_FLUSH: list = []


def cold_ms(fn, reps: int) -> float:
    """chip_smoke.py's timer: mean device time of one call with a 256 MB
    buffer read and written before it (outside the event pair)."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in pairs:
        _FLUSH[0].add_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def ptxas_report(tmp: Path) -> list[dict]:
    """Registers, spill bytes and shared memory of every kernel instance."""
    from dynamo_tpu_torch.ops import _build

    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp / "ptxas.so"),
         str(_build.CSRC_DIR / "paged_attention.cu")],
        capture_output=True, text=True, check=True,
    )
    out, name = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = subprocess.run(["c++filt", m.group(1)], capture_output=True, text=True).stdout.strip()
            out.append({"kernel": name})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and out:
            out[-1]["spill_stores"], out[-1]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[-1]["static_smem"] = int(s.group(1)) if s else 0
    return out


def build_stages(tmp: Path, depths) -> dict:
    """One library per ring depth, from copies of the source."""
    from dynamo_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / "paged_attention.cu").read_text()
    anchor = "constexpr int kStages = "
    if text.count(anchor) != 1:
        raise AssertionError("the ring depth's anchor is not in paged_attention.cu once")

    def one(n):
        src = tmp / f"paged_attention_stages{n}.cu"
        src.write_text(re.sub(r"constexpr int kStages = \d+;", f"constexpr int kStages = {n};", text))
        _build.build(src, src.with_suffix(".so"))
        return ctypes.CDLL(str(src.with_suffix(".so")))

    with ThreadPoolExecutor(len(depths)) as pool:
        return dict(zip(depths, pool.map(one, depths)))


def split_counts(pa, B, n_kv, max_blocks, bs, sms, positions, per_sm) -> list[int]:
    """One split, and the split counts some plan of the given split lengths
    and blocks per SM picks."""
    saved = pa.SPLIT_POSITIONS, pa.MAX_SPLIT_BLOCKS_PER_SM
    got = {1}
    try:
        for f in positions:
            for b in per_sm:
                pa.SPLIT_POSITIONS, pa.MAX_SPLIT_BLOCKS_PER_SM = f, b
                got.add(pa.paged_split_plan(B, n_kv, max_blocks, bs, sms)[0])
    finally:
        pa.SPLIT_POSITIONS, pa.MAX_SPLIT_BLOCKS_PER_SM = saved
    return sorted(got)


def host_us(reps: int = 500, rounds: int = 5) -> list[float]:
    """The wrapper's host cost per call, ``rounds`` means of ``reps``
    back-to-back ``paged_attention`` calls at the comparison's shape with
    every sequence at one position, so the device keeps up and the host
    sets the pace."""
    from dynamo_tpu_torch.ops.paged_attention import paged_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    args, kw = operands(16, 8, 4, 32, 8, [1] * 16, torch.float32, gen, False)
    call = lambda: paged_attention(*args, **kw)  # noqa: E731
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", type=int, nargs="+", default=[2, 3, 4, 6])
    ap.add_argument("--split-positions", type=int, nargs="+", default=[64, 128, 256, 480, 512, 1024])
    ap.add_argument("--max-blocks-per-sm", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--host-us-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_paged_attention: no CUDA card", file=sys.stderr)
        return 2
    import dynamo_tpu_torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    if args.host_us_only:
        us = host_us()
        print(f"paged_attention wrapper host us per call: " + " ".join(f"{x:.1f}" for x in us), flush=True)
        print(json.dumps({"card": card, "package": dynamo_tpu_torch.__file__, "host_us": us}), flush=True)
        return 0

    from dynamo_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    sms = pa.sm_count(0)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(2) as pool:
            ptx = pool.submit(ptxas_report, Path(tmp))
            libs = build_stages(Path(tmp), args.stages)
            report = ptx.result()
    for r in report:
        print(f"ptxas: {r}", flush=True)

    runs = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, B, n_kv, group, bs, mb, lens, q_dtype in cases():
        counts = split_counts(pa, B, n_kv, mb, bs, sms, args.split_positions, args.max_blocks_per_sm)
        for int8 in (False, True):
            ops, kw = operands(B, n_kv, group, bs, mb, lens, q_dtype, gen, int8)
            want = pa.paged_attention_reference(*ops, **kw).float()
            for stages, lib in libs.items():
                fn = pa.bind(lib)
                for n in counts:
                    run = lambda: pa.launch(fn, *ops, n_splits=n, **kw)  # noqa: E731
                    got = run().float()
                    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-12)).max().item()
                    ms = cold_ms(run, args.reps)
                    per = pa.launch_plan(B, n_kv * group, n_kv, bs, mb, sms, n)[0][-1]
                    runs.append(dict(shape=name, pages="int8" if int8 else "bf16", stages=stages,
                                     n_splits=n, pages_per_split=per, ms=ms, max_row_rel_err=rel))
                    print(f"{name} {runs[-1]['pages']} stages={stages} n_splits={n} "
                          f"({per * bs} positions a split): {ms:.4f} ms, max_row_rel_err {rel:.2e}",
                          flush=True)
                    if not rel <= ROW_REL_TOL:
                        raise AssertionError(f"K2 disagrees with its plain version: {runs[-1]}")
            del ops, kw, want
            torch.cuda.empty_cache()
    best = {}
    for r in runs:
        key = (r["shape"], r["pages"])
        if key not in best or r["ms"] < best[key]["ms"]:
            best[key] = r
    for r in best.values():
        print(f"fastest {r['shape']} {r['pages']}: stages={r['stages']} n_splits={r['n_splits']} "
              f"{r['ms']:.4f} ms", flush=True)
    us = host_us()
    print(f"paged_attention wrapper host us per call: " + " ".join(f"{x:.1f}" for x in us), flush=True)
    print(json.dumps({"card": card, "package": dynamo_tpu_torch.__file__, "ptxas": report,
                      "runs": runs, "host_us": us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``dynamo_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

It (1) prints the card's name and power limit, (2) builds every kernel of
the port from ``dynamo_tpu_torch/csrc`` with nvcc, (3) holds each kernel
against its plain PyTorch version on the card at llama3-8b head shapes and
times both, and shows that the comparison fails kernels built with
planted faults, (4) serves 8 requests through ``build_engine("llama3-8b")`` and
``TorchEngine.generate`` at full width and depth with random weights,
checking token counts, finish reasons, the prefix cache, the kernel's
launch count, finite logits and megastep k=1 == k=8 greedy streams, and
(5) prints a JSON line of kernel measurements and, last, a JSON status
line. Any failed check raises and the script exits non-zero. Without a
card it exits non-zero at once and prints no result.
"""

from __future__ import annotations

import asyncio
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
N_Q, N_KV, HEAD_DIM, PAGE = 32, 8, 128, 32  # llama3-8b attention geometry
# Kernel against plain version: the largest relative L2 error of one
# output vector (one query row, one head) over the real rows. Both sides
# round to bf16 (relative step 2**-8, so ~1e-3 per vector in L2) and sum in
# other orders. The limit is scaled to the output, whose size falls as
# 1/sqrt(visible positions): an absolute limit that passes bf16 rounding
# at short rows would pass a dropped tile at 4096 positions.
ROW_REL_TOL = 1e-2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- kernel against its plain version --------------------------------------

def compare(got, want, n_real: int) -> tuple[float, float, bool]:
    """(largest relative L2 error of an output vector, largest absolute
    error, ok): ok when the first is within ROW_REL_TOL and every padded
    row past the ``n_real`` real ones is zero."""
    g, w = got[:n_real].float(), want[:n_real].float()
    rel = ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-12)).max().item()
    err = (got.float() - want.float()).abs().max().item()
    return rel, err, rel <= ROW_REL_TOL and not got[n_real:].any().item()


def attention_batch(q_lens, kv_lens, S, pages_per_seq, T, gen):
    """Ragged operands on the card: sequence s owns q rows cu[s]..cu[s+1]-1
    and its own pages; rows past cu[num_seqs] and table entries past a
    sequence's pages point at the garbage page."""
    dev = "cuda"
    n_pages = sum(-(-L // PAGE) for L in kv_lens) + 1
    q = torch.randn(T, N_Q, HEAD_DIM, device=dev, generator=gen).bfloat16()
    kv = torch.randn(n_pages, PAGE, 2 * N_KV, HEAD_DIM, device=dev, generator=gen).bfloat16()
    perm = torch.randperm(n_pages - 1, device=dev, generator=gen).to(torch.int32)
    tables = torch.full((S, pages_per_seq), n_pages - 1, dtype=torch.int32, device=dev)
    off = 0
    for s, L in enumerate(kv_lens):
        npg = -(-L // PAGE)
        tables[s, :npg] = perm[off : off + npg]
        off += npg
    lens = np.zeros(S, np.int32)
    lens[: len(kv_lens)] = kv_lens
    cu = np.zeros(S + 1, np.int32)
    cu[1 : len(q_lens) + 1] = np.cumsum(q_lens)
    cu[len(q_lens) + 1 :] = cu[len(q_lens)]
    as_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (q, kv, as_dev(lens), tables, as_dev(cu),
            as_dev(np.array([len(q_lens)], np.int32)))


def attention_bound(q_lens, kv_lens, T):
    """Least time for this call's work: each input byte the data needs
    read once (q rows, the visible K/V rows, the table entries in use),
    the output written once; operations 4 * visible positions * n_q * d
    (QK^T and PV, a multiply-add counted as 2)."""
    kv_rows = sum(kv_lens)
    pages = sum(-(-L // PAGE) for L in kv_lens)
    nbytes = (
        sum(q_lens) * N_Q * HEAD_DIM * 2        # q (bf16)
        + kv_rows * 2 * N_KV * HEAD_DIM * 2     # K and V rows (bf16)
        + T * N_Q * HEAD_DIM * 2                # out (bf16)
        + 4 * (pages + 2 * len(kv_lens) + 2)    # tables, kv_lens, cu, num_seqs
    )
    visible = sum(
        min(L - q + i + 1, L) for q, L in zip(q_lens, kv_lens) for i in range(q)
    )
    ops = 4 * visible * N_Q * HEAD_DIM
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_attention_kernel(ra) -> tuple[list[dict], list[tuple]]:
    """The kernel against ragged_paged_attention_ref on several ragged
    batches at llama3-8b head shapes; returns the measurements and, for the
    planted-fault check, each batch with its plain output. pages_per_seq
    stays <= 128: the plain version materialises [T, pages_per_seq*32, 16,
    128] f32 (decode64: 64 * 4096 * 16 * 128 * 4 B = 2.1 GB; mixed_padded:
    512 * 2048 * 16 * 128 * 4 B = 8.6 GB)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    cases = [
        # name, q_lens, kv_lens, S, pages_per_seq, T (bucket)
        ("decode8", [1] * 8, [4096, 3000, 2048, 1500, 1024, 700, 300, 33], 8, 128, 8),
        ("decode64", [1] * 64, [int(x) for x in rng.integers(1, 4097, 64)], 64, 128, 64),
        ("mixed_padded", [256, 64, 1, 1, 1, 1], [256, 1024, 2000, 1500, 64, 500], 8, 64, 512),
        ("pages_edge_padded", [32, 1, 1], [64, 2048, 32], 6, 64, 64),
    ]
    scale = HEAD_DIM ** -0.5
    results, batches = [], []
    for name, q_lens, kv_lens, S, pps, T in cases:
        args = attention_batch(q_lens, kv_lens, S, pps, T, gen)
        kernel = lambda: ra.ragged_paged_attention(*args, sm_scale=scale)  # noqa: E731
        plain = lambda: ra.ragged_paged_attention_ref(*args, sm_scale=scale)  # noqa: E731
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        rel, err, ok = compare(got, want, sum(q_lens))
        ms = cuda_ms(kernel, 50)
        plain_ms = cuda_ms(plain, 3)
        bound_ms, bound_by = attention_bound(q_lens, kv_lens, T)
        results.append(dict(
            shape=name, T=T, S=S, num_seqs=len(q_lens), max_kv_len=max(kv_lens),
            ok=ok, max_row_rel_err=rel, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by,
        ))
        print(f"attention {name}: ok={ok} max_row_rel_err={rel:.3e} max_abs_err={err:.3e} "
              f"kernel {ms:.4f} ms plain {plain_ms:.3f} ms bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        batches.append((name, args, want, sum(q_lens)))
        del got
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"attention kernel disagrees with its plain version on {name}")
    return results, batches


# Faults planted in copies of the kernel's source: (text, replacement).
PLANTED_FAULTS = {
    "drops_second_tile": (
        "const int n = min(kTile, n_vis - base);",
        "const int n = min(kTile, n_vis - base);\n    if (base == kTile) continue;",
    ),
    "misses_own_position": (
        "const int n_vis = min(abs_pos + 1, kv_len);",
        "const int n_vis = min(abs_pos, kv_len);",
    ),
    "sees_next_position": (
        "const int n_vis = min(abs_pos + 1, kv_len);",
        "const int n_vis = min(abs_pos + 2, kv_len);",
    ),
}


def check_planted_faults(ra, batches) -> dict:
    """Build each planted fault's copy of the kernel in a scratch directory
    and run it on the batches above: the comparison must fail every one on
    at least one batch, or its limit is too loose to mean anything."""
    from dynamo_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / "ragged_paged_attention.cu").read_text()
    found = {}
    with tempfile.TemporaryDirectory() as tmp:
        def build(name):
            old, new = PLANTED_FAULTS[name]
            if text.count(old) != 1:
                raise AssertionError(f"planted fault {name}: its anchor is not in the source once")
            src = Path(tmp, f"{name}.cu")
            src.write_text(text.replace(old, new))
            _build.build(src, src.with_suffix(".so"))
            return name, ra.bind(ctypes.CDLL(str(src.with_suffix(".so"))))

        with ThreadPoolExecutor(len(PLANTED_FAULTS)) as pool:
            kernels = dict(pool.map(build, PLANTED_FAULTS))
        for name, fn in kernels.items():
            rels = {
                shape: compare(
                    ra.launch(fn, *args, sm_scale=HEAD_DIM ** -0.5), want, n_real
                )[0]
                for shape, args, want, n_real in batches
            }
            found[name] = max(rels.values())
            print(f"planted fault {name}: max_row_rel_err by batch "
                  + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
                  + f"; caught={found[name] > ROW_REL_TOL}", flush=True)
            if found[name] <= ROW_REL_TOL:
                raise AssertionError(f"the comparison passes planted fault {name}")
    return found


def plain_by_row_chunks(ra, args, q_lens, rows=64):
    """The plain version over a batch too large for it in one call: each
    run of ``rows`` query rows of a sequence goes through it alone, as the
    last rows of that sequence cut at the chunk's end (same absolute
    positions, same visible keys), so each call materialises at most
    ``rows`` x 2048 positions."""
    q, kv, lens, tables, cu, _ = args
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=q.device)  # noqa: E731
    lens_h, cu_h = lens.tolist(), cu.tolist()
    out = torch.zeros_like(q)
    for s, ql in enumerate(q_lens):
        for a in range(0, ql, rows):
            b = min(a + rows, ql)
            kv_len = lens_h[s] - ql + b
            r0, r1 = cu_h[s] + a, cu_h[s] + b
            out[r0:r1] = ra.ragged_paged_attention_ref(
                q[r0:r1], kv, i32([kv_len]), tables[s : s + 1, : -(-kv_len // PAGE)],
                i32([0, b - a]), i32([1]), sm_scale=HEAD_DIM ** -0.5,
            )
    return out


def check_serving_prefill_shape(ra, prompt_lens) -> dict:
    """The kernel at the serving prefill wave's shape (bucket 8192, S = 8,
    pages_per_seq 256), held against the plain version run in row chunks
    (in one call it would materialise 8192 x 8192 x 16 x 128 f32)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    args = attention_batch(prompt_lens, prompt_lens, 8, 256, 8192, gen)
    kernel = lambda: ra.ragged_paged_attention(*args, sm_scale=HEAD_DIM ** -0.5)  # noqa: E731
    plain = lambda: plain_by_row_chunks(ra, args, prompt_lens)  # noqa: E731
    got = kernel()
    want = plain()
    rel, err, ok = compare(got, want, sum(prompt_lens))
    ms = cuda_ms(kernel, 5)
    plain_ms = cuda_ms(plain, 1)
    bound_ms, bound_by = attention_bound(prompt_lens, prompt_lens, 8192)
    print(f"attention prefill_wave8192: ok={ok} max_row_rel_err={rel:.3e} "
          f"max_abs_err={err:.3e} kernel {ms:.4f} ms plain (row chunks) {plain_ms:.3f} ms "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    del args, got, want
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("attention kernel disagrees with its plain version on prefill_wave8192")
    return dict(shape="prefill_wave8192", T=8192, S=8, num_seqs=len(prompt_lens),
                max_kv_len=max(prompt_lens), ok=ok, max_row_rel_err=rel, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


# -- the serving path -------------------------------------------------------

MAX_TOKENS = 64
SHARED_PREFIX = 1024  # tokens two requests share (32 blocks)


def serving_requests(vocab: int):
    rng = np.random.default_rng(1234)
    ids = lambda n: [int(t) for t in rng.integers(0, vocab, n)]  # noqa: E731
    shared = ids(SHARED_PREFIX)
    greedy = {"temperature": 0.0}
    reqs = [  # (id, prompt, sampling)
        ("long", ids(2000), greedy),
        ("prefix_a", shared + ids(100), greedy),
        ("temp", ids(100), {"temperature": 0.8, "seed": 7}),
        ("top_p", ids(700), {"temperature": 1.0, "top_p": 0.9, "seed": 11}),
        ("mid", ids(1500), greedy),
        ("short", ids(300), greedy),
        ("long2", ids(1800), greedy),
    ]
    late = ("prefix_b", shared + ids(50), greedy)  # sent once prefix_a has streamed
    solo = ("solo", ids(400), greedy)              # k=1 vs k=8 comparison
    return reqs, late, solo


def wire(rid, prompt, sampling):
    return {"model": "llama3-8b", "token_ids": prompt, "request_id": rid,
            "sampling": sampling, "stop": {"max_tokens": MAX_TOKENS}}


async def collect(engine, Context, rid, prompt, sampling, first=None):
    tokens, finish, meta = [], None, {}
    async for out in engine.generate(wire(rid, prompt, sampling), Context(rid)):
        tokens += out["token_ids"]
        meta.update(out.get("meta", {}))
        finish = out.get("finish_reason")
        if first is not None:
            first.set()
    return rid, tokens, finish, meta


async def serve_concurrent(engine, Context, reqs, late):
    prefix_streamed = asyncio.Event()

    async def late_request():
        await prefix_streamed.wait()
        return await collect(engine, Context, *late)

    tasks = [
        collect(engine, Context, *r, first=prefix_streamed if r[0] == "prefix_a" else None)
        for r in reqs
    ]
    done = await asyncio.wait_for(asyncio.gather(*tasks, late_request()), timeout=600)
    return {rid: (toks, fin, meta) for rid, toks, fin, meta in done}


LOGITS_MIN_COSINE = 0.9995  # 1 - cos measured at 1.4e-4 over 32 bf16 layers


def check_logits(core, prompt) -> dict:
    """Logits of one short prompt through the engine's weights on a scratch
    cache, once with the kernel and once with the plain attention: finite,
    of the expected shape, and pointing the same way."""
    from dynamo_tpu_torch.engine import model
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.ops import ragged_attention as ra

    cfg = core.cfg
    eng = EngineConfig(num_kv_blocks=8, max_model_len=256)
    n, bs = len(prompt), eng.block_size
    dev = core.device
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    pos = list(range(n))
    table = list(range(8)) + [eng.garbage_block] * (eng.max_blocks_per_seq - 8)
    ops = (i32(prompt), i32(pos), i32([p // bs for p in pos]), i32([p % bs for p in pos]),
           i32([n]), i32([table]), i32([0, n]), i32([1]), i32([n - 1]))

    def run(attention):
        cache = model.init_cache(cfg, eng, dev)
        return model.forward_tokens(core.params, cache, *ops, cfg, attention=attention)

    with_kernel = run(ra.ragged_paged_attention)
    with_plain = run(ra.ragged_paged_attention_ref)
    cos = torch.nn.functional.cosine_similarity(with_kernel, with_plain).item()
    finite = bool(torch.isfinite(with_kernel).all().item())
    print(f"logits: shape {tuple(with_kernel.shape)} finite={finite} "
          f"cosine(kernel, plain attention)={cos:.6f} "
          f"max_abs_diff={(with_kernel - with_plain).abs().max().item():.4e}", flush=True)
    if not finite or with_kernel.shape != (1, cfg.vocab_size) or cos < LOGITS_MIN_COSINE:
        raise AssertionError("logits are not finite, misshapen, or disagree with the plain path")
    return {"cosine": cos}


def serve(ra, card: str) -> tuple[int, dict]:
    from dynamo_tpu_torch.backends.torch.main import build_engine
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime.engine import Context

    t0 = time.time()
    core, engine = build_engine("llama3-8b", seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"built {core.cfg.name} engine ({core.cfg.num_layers} layers, {core.cfg.dtype}, random weights, "
          f"{core.engine.num_kv_blocks} x {core.engine.block_size}-token KV blocks) "
          f"in {time.time() - t0:.1f} s; allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    reqs, late, solo = serving_requests(core.cfg.vocab_size)

    # The main path, with every kernel launch count at 0 just before it.
    ra.launches = 0
    t_serve = time.time()
    results = asyncio.run(serve_concurrent(engine, Context, reqs, late))
    serve_s = time.time() - t_serve
    launches = ra.launches
    st = core.scheduler_stats()
    forwards = st["forwards"]

    for rid, (toks, fin, meta) in results.items():
        print(f"request {rid}: {len(toks)} tokens, finish={fin}, "
              f"cached_tokens={meta.get('cached_tokens')}", flush=True)
        if len(toks) != MAX_TOKENS or fin != "length":
            raise AssertionError(f"{rid}: {len(toks)} tokens, finish {fin!r}")
    if launches != core.cfg.num_layers * forwards or launches == 0:
        raise AssertionError(
            f"attention launches {launches} != {core.cfg.num_layers} x {forwards} forwards"
        )
    kv = core.kv_cache_stats()
    if results["prefix_b"][2].get("cached_tokens") != SHARED_PREFIX or kv["admitted_hits"] < 1:
        raise AssertionError(f"shared prefix missed the prefix cache: {kv}")
    print(f"main path: {len(results)} requests in {serve_s:.2f} s; forwards {forwards} "
          f"(prefill waves + decode iterations), attention launches {launches} = "
          f"{core.cfg.num_layers} x {forwards}; dispatches {st['dispatches']} "
          f"(megastep {st['megastep_dispatches']})", flush=True)
    prefill_tps = st["prefill_tokens"] / st["prefill_s"]
    decode_ms = 1e3 * st["decode_s"] / st["decode_iterations"]
    print(f"serving on {card}: prefill {prefill_tps:.0f} tokens/s "
          f"({st['prefill_tokens']} tokens in {st['prefill_s']:.3f} s), decode "
          f"{decode_ms:.2f} ms per iteration ({st['decode_iterations']} iterations, "
          f"{st['decode_s']:.3f} s)", flush=True)

    logit_check = check_logits(core, reqs[5][1][:64])

    # Megastep k=1 against k=8: a second engine on the same weight tensors.
    # Each event loop gets its own facade (asyncio objects bind to a loop).
    _, engine1 = build_engine("llama3-8b", {"megastep_k": 1}, device="cuda", params=core.params)

    async def solo_on(eng):
        return await collect(eng, Context, *solo)

    k8 = asyncio.run(solo_on(TorchEngine(core)))[1]
    k1 = asyncio.run(solo_on(engine1))[1]
    print(f"greedy solo request: k=8 and k=1 streams equal={k8 == k1} "
          f"({len(k8)} tokens)", flush=True)
    if k8 != k1 or len(k8) != MAX_TOKENS:
        raise AssertionError("megastep k=8 and k=1 greedy streams differ")
    return launches, {
        "requests": len(results), "serve_s": serve_s, "forwards": forwards,
        "prefill_tokens_per_s": prefill_tps, "decode_ms_per_iteration": decode_ms,
        "logits_cosine": logit_check["cosine"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from dynamo_tpu_torch.engine.config import llama3_8b
    from dynamo_tpu_torch.ops import _build
    from dynamo_tpu_torch.ops import ragged_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.time()
    _build.load("ragged_paged_attention")
    print(f"kernel build: ragged_paged_attention.cu in {time.time() - t0:.1f} s", flush=True)

    shapes, batches = check_attention_kernel(ra)
    faults = check_planted_faults(ra, batches)
    del batches
    reqs, _, _ = serving_requests(llama3_8b().vocab_size)
    shapes.append(check_serving_prefill_shape(ra, [len(p) for _, p, _ in reqs]))
    torch.cuda.empty_cache()

    launches, summary = serve(ra, card)
    print(f"serving summary: {json.dumps(summary)}", flush=True)

    main_shape = shapes[0]  # decode width 8, the serving decode width
    print(json.dumps({"kernels": [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "dynamo_tpu/ops/ragged_attention.py:163",
        "launches": launches,
        "ok": all(s.get("ok", True) for s in shapes),
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "max_row_rel_err": max(s["max_row_rel_err"] for s in shapes),
        "row_rel_tol": ROW_REL_TOL,
        "planted_faults_row_rel_err": faults,
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "shape": main_shape["shape"],
        "shapes": shapes,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

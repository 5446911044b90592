"""Two builds of K1's source against each other on one card, in turns.

Run from the repository root, beside ``chip_smoke.py`` (whose shapes and
timer it uses), on a machine with one CUDA card::

    git show <commit>:dynamo_tpu_torch/csrc/ragged_paged_attention.cu > OTHER.cu
    python3 k1_source_ab.py OTHER.cu [--out-dir DIR]

It builds ``OTHER.cu`` (e.g. an older tree's K1) and this checkout's
``csrc/ragged_paged_attention.cu`` through the port's build
(``ops/_build.build``) with ``-Xptxas -v`` (the libraries and each compiler
log written to ``--out-dir``, by default the git-ignored
``dynamo_tpu_torch/_build/k1_source_ab``), both at once, binds both
libraries' head_dim-128 entry points, and runs each on ``chip_smoke.py``'s
llama3-8b shapes: the serving decode form (decode kernel, T = S = 8, kv
148-2048) and the serving prefill wave (tiled kernel, T 8192), with bf16
and int8 pages. For each it prints whether the two outputs are bit-equal
and each library's time with the L2 flushed (``chip_smoke.cold_ms``, 20
calls) in the turns other, this, this, other, other, this, beside the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

TURNS = ("other", "this", "this", "other", "other", "this")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="another K1 source to hold this checkout's against")
    ap.add_argument("--out-dir", default=None, help="where the libraries and compiler logs go")
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from dynamo_tpu_torch.engine.config import llama3_8b
    from dynamo_tpu_torch.ops import _build
    from dynamo_tpu_torch.ops import ragged_attention as ra

    if not torch.cuda.is_available():
        print("k1_source_ab: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}", flush=True)
    out_dir = Path(args.out_dir) if args.out_dir else _build.BUILD_DIR / "k1_source_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {"other": Path(args.other),
               "this": _build.CSRC_DIR / "ragged_paged_attention.cu"}
    with ThreadPoolExecutor(len(sources)) as pool:
        logs = {tag: pool.submit(_build.build, src, out_dir / f"k1_{tag}.so", ("-Xptxas", "-v"))
                for tag, src in sources.items()}
    libs = {}
    for tag, log in logs.items():
        (out_dir / f"ptxas_k1_{tag}.txt").write_text(log.result())
        libs[tag] = ctypes.CDLL(str(out_dir / f"k1_{tag}.so"))

    reqs, late, _ = cs.serving_requests(llama3_8b().vocab_size)
    prompt_lens = [len(p) for _, p, _ in reqs]
    decode_lens = [n + 48 for n in prompt_lens + [len(late[1])]]
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {
        "decode_serving8": ("decode", cs.attention_batch([1] * 8, decode_lens, 8, 256, 8, gen)),
        "prefill_wave8192": ("tiled", cs.attention_batch(prompt_lens, prompt_lens, 8, 256, 8192,
                                                         gen)),
    }
    for name, (kernel, (base_args, base_kw)) in cases.items():
        for int8 in (False, True):
            a, kw = cs.quantized(base_args, base_kw) if int8 else (base_args, base_kw)
            entries = {tag: ra.bind(lib, int8) for tag, lib in libs.items()}

            def run(tag):
                return ra.launch(entries[tag], *a, sm_scale=128 ** -0.5, kernel=kernel, **kw)

            same = torch.equal(run("other"), run("this"))
            times = [(tag, cs.cold_ms(lambda: run(tag), 20)) for tag in TURNS]
            print(f"{name} {'int8' if int8 else 'bf16'} pages, {kernel} kernel: outputs "
                  f"bit-equal {same}; ms " + ", ".join(f"{t} {ms:.4f}" for t, ms in times),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's single-command runner (``python -m dynamo_tpu_torch.run``):
the counterparts of ``tests/test_run_cli.py``'s echo and mocker runs; the
torch worker on the CPU against the JAX runner's ``--out jax`` on the same
prompts; and the refusal, before anything starts, of a model the card's
attention kernel cannot run."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = ["hello", "the quick brown fox", "a b c"]


def _run(args, timeout=180, code=None):
    cmd = [sys.executable, "-c", code] if code else [sys.executable, "-m", *args]
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, timeout=timeout, text=True)


def test_batch_echo(tmp_path):
    inp = tmp_path / "in.jsonl"
    out = tmp_path / "out.jsonl"
    inp.write_text('{"prompt": "hello"}\n{"prompt": "there"}\n')
    proc = _run(["dynamo_tpu_torch.run", "--in", "batch", "--out", "echo",
                 "--input", str(inp), "--output", str(out), "--max-tokens", "8"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(lines) == 2
    # The echo engine streams the templated prompt's own bytes back.
    assert lines[0]["completion"].startswith("<|user|>")


def test_text_mocker_oneshot():
    proc = _run(["dynamo_tpu_torch.run", "--in", "text", "--out", "mocker",
                 "--prompt", "hi", "--max-tokens", "6", "--speedup-ratio", "100"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "abcdef" in proc.stdout


# Neither runner has a sampling flag, and a chat request without a
# temperature samples at the engine's default (1.0, unseeded), so the
# comparison makes every chat request of both runners greedy: it sets
# "temperature": 0 in the body the runner posts, and changes nothing else.
# The two packages draw a preset's random weights with different
# generators, so the torch runner's worker is given the JAX worker's draw
# (``init_params(PRNGKey(0), tiny_model())``, the JAX engine's seed-0
# weights), converted, in place of its own.
GREEDY_RUNNER = textwrap.dedent("""
    import sys

    import aiohttp

    if sys.argv[1] == "dynamo_tpu_torch.run":
        import jax
        import numpy as np

        from dynamo_tpu.engine.config import tiny_model as jax_tiny_model
        from dynamo_tpu.engine.model import init_params
        from dynamo_tpu_torch.backends.torch import main as worker
        from dynamo_tpu_torch.engine.config import tiny_model
        from dynamo_tpu_torch.engine.convert import params_from_numpy

        jax_params = init_params(jax.random.PRNGKey(0), jax_tiny_model())
        params = params_from_numpy(jax.tree.map(np.asarray, jax_params), tiny_model(),
                                   device="cpu")
        _build_engine = worker.build_engine

        def build_engine(*a, **kw):
            assert kw.get("params") is None and kw.get("seed", 0) == 0
            return _build_engine(*a, **{**kw, "params": params})

        worker.build_engine = build_engine

    _post = aiohttp.ClientSession.post

    def post(self, url, *, json=None, **kw):
        if json is not None and str(url).endswith("/v1/chat/completions"):
            json = dict(json, temperature=0.0)
        return _post(self, url, json=json, **kw)

    aiohttp.ClientSession.post = post
    module, argv = sys.argv[1], sys.argv[2:]
    sys.argv = [module, *argv]
    __import__(module, fromlist=["main"]).main()
""")


def _greedy_batch(module: str, out_args: list[str], inp: Path, out: Path) -> list[dict]:
    proc = subprocess.run(
        [sys.executable, "-c", GREEDY_RUNNER, module, "--in", "batch", *out_args,
         "--input", str(inp), "--output", str(out), "--max-tokens", "12"],
        cwd=ROOT, capture_output=True, timeout=600, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(ln) for ln in out.read_text().splitlines()]


def test_batch_torch_tiny_matches_jax_runner(tmp_path):
    inp = tmp_path / "in.jsonl"
    inp.write_text("".join(json.dumps({"prompt": p}) + "\n" for p in PROMPTS))
    got = _greedy_batch("dynamo_tpu_torch.run",
                        ["--out", "torch", "--preset", "tiny", "--device", "cpu"],
                        inp, tmp_path / "torch.jsonl")
    want = _greedy_batch("dynamo_tpu.run", ["--out", "jax", "--preset", "tiny"],
                         inp, tmp_path / "jax.jsonl")
    assert [g["prompt"] for g in got] == PROMPTS
    assert got == want
    # A failed request still writes a row: "[error] <message>".
    assert not any(g["completion"].startswith("[error]") for g in got + want)
    assert any(g["completion"] for g in got)


def test_torch_tiny_on_cuda_refused_before_start():
    """The f32 ``tiny`` preset (head_dim 16) is refused on ``cuda``, the
    default device, before the store or the worker starts: the card's
    attention kernel cannot run it, and nothing falls back to the plain
    version."""
    proc = _run(["dynamo_tpu_torch.run", "--in", "text", "--out", "torch",
                 "--preset", "tiny", "--prompt", "hi"], timeout=120)
    assert proc.returncode != 0
    assert "ValueError: model 'tiny' cannot run on the card's attention kernel" in proc.stderr
    assert "dtype float32" in proc.stderr and "head_dim 16" in proc.stderr
    assert "serving OpenAI API" not in proc.stdout and not proc.stdout.strip()


def test_torch_entry_points_use_one_malloc_arena():
    """The worker's CLI and the runner's torch path put every thread on
    glibc's main malloc arena before any thread starts (the engine steps on
    an executor thread); the setting takes here."""
    import ast

    from dynamo_tpu_torch.backends.torch.main import use_one_malloc_arena

    proc = subprocess.run(
        [sys.executable, "-c", "from dynamo_tpu_torch.backends.torch.main import "
         "use_one_malloc_arena as f; print(f())"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.stdout.strip() == "True", proc.stderr[-2000:]
    assert callable(use_one_malloc_arena)
    for rel in ("dynamo_tpu_torch/backends/torch/main.py", "dynamo_tpu_torch/run.py"):
        tree = ast.parse((ROOT / rel).read_text())
        main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
        calls = [n.func.id for n in ast.walk(main)
                 if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
        assert "use_one_malloc_arena" in calls, rel
        assert calls.index("use_one_malloc_arena") < calls.index("check_slice"), rel

"""The port's doctor (``python -m dynamo_tpu_torch.check``): one line per
check, exit 1 on any failure. ``--device cpu`` passes here with the card's
lines skipped; the default device on a machine without a card fails its
device line instead of moving to the CPU; ``grpc`` is optional."""

import asyncio
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
IMPORTS = ["torch", "numpy", "aiohttp", "msgpack", "xxhash", "pydantic", "grpc"]


def _doctor(*args, env=None):
    proc = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.check", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=180, env=env)
    return proc.returncode, proc.stdout.splitlines()


def _marks(lines):
    """Each line's label and its mark, ``ok`` or ``FAIL``."""
    out = {}
    for ln in lines:
        mark, rest = ln[1:].split("] ", 1)
        out[rest.split(" — ")[0]] = mark.strip()
    return out


def test_cpu_skip_engine_passes():
    rc, lines = _doctor("--device", "cpu", "--skip-engine")
    assert rc == 0, lines
    marks = _marks(lines)
    for mod in IMPORTS:
        assert marks[f"import {mod}"] == "ok"
    assert "[ok ] cuda devices — skipped (--device cpu)" in lines
    assert "[ok ] CUDA kernels — skipped (--device cpu)" in lines
    assert "[ok ] store — skipped (no --store-address)" in lines
    assert not any("engine smoke" in ln for ln in lines)
    assert sum(ln.startswith("[ok ] native radix index") for ln in lines) == 1


def test_cpu_engine_two_greedy_tokens():
    rc, lines = _doctor("--device", "cpu")
    assert rc == 0, lines
    assert ("[ok ] engine smoke (tiny model, f32, plain versions, 2 tokens) — 2 tokens, "
            "K1 launches 0") in lines


def test_default_device_without_card_fails():
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a card")
    rc, lines = _doctor("--skip-engine")
    assert rc == 1, lines
    assert _marks(lines)["cuda devices"] == "FAIL"
    assert any(ln.startswith("[FAIL] cuda devices — torch.cuda.is_available() is False")
               for ln in lines)


def test_missing_grpc_is_optional(tmp_path):
    """Without ``grpcio`` (as on the card machine) the doctor still passes,
    and says what cannot start."""
    (tmp_path / "grpc.py").write_text("raise ImportError('No module named grpc')\n")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}:{ROOT}"}
    rc, lines = _doctor("--device", "cpu", "--skip-engine", env=env)
    assert rc == 0, lines
    assert ("[ok ] import grpc — unavailable; the KServe gRPC frontend cannot start") in lines


def test_store_line_reads_a_live_store():
    """Against a running store the store line counts its models and
    instances (none here)."""
    from dynamo_tpu_torch.runtime.store import StoreServer

    async def run():
        store = StoreServer()
        await store.start()
        try:
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "dynamo_tpu_torch.check", "--device", "cpu",
                "--skip-engine", "--store-address", store.address, cwd=ROOT,
                stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
            out, _ = await asyncio.wait_for(proc.communicate(), 120)
            return proc.returncode, out.decode().splitlines(), store.address
        finally:
            await store.stop()

    rc, lines, address = asyncio.run(run())
    assert rc == 0, lines
    assert f"[ok ] store — {address}: 0 models, 0 instances" in lines

"""dynamo-tpu doctor on the port: environment and cluster diagnostics.

The port's counterpart of ``dynamo_tpu/check.py``: checks the Python
stack, the CUDA card, the port's two kernel libraries, the native radix
index, a two-token engine run and the control-plane store, and prints one
line per check; it exits 1 when any check fails. It is the first command
to run on a card:

    python -m dynamo_tpu_torch.check [--store-address HOST:PORT] [--device cpu]

On ``cuda`` (the default) a machine without a card fails the device line:
the doctor never moves to the CPU on its own. The engine check runs the
f32 ``tiny`` model, on the card through K1's generic instance (it reports
K1's launches), with ``--device cpu`` on the plain versions, which also
skips the card's lines. ``grpc`` is optional: without it
only the KServe gRPC frontend cannot start.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import sys

REQUIRED = ("torch", "numpy", "aiohttp", "msgpack", "xxhash", "pydantic")
OPTIONAL = {"grpc": "the KServe gRPC frontend cannot start"}


def _line(ok: bool, label: str, detail: str = "") -> bool:
    mark = "ok " if ok else "FAIL"
    print(f"[{mark}] {label}" + (f" — {detail}" if detail else ""), flush=True)
    return ok


def check_imports() -> bool:
    ok = True
    for mod in REQUIRED:
        try:
            importlib.import_module(mod)
            _line(True, f"import {mod}")
        except ImportError as e:
            ok = _line(False, f"import {mod}", str(e))
    for mod, without in OPTIONAL.items():
        try:
            importlib.import_module(mod)
            _line(True, f"import {mod}")
        except ImportError:
            _line(True, f"import {mod}", f"unavailable; {without}")
    return ok


def check_cuda(device: str) -> bool:
    if device == "cpu":
        return _line(True, "cuda devices", "skipped (--device cpu)")
    try:
        import torch

        if not torch.cuda.is_available():
            return _line(False, "cuda devices",
                         "torch.cuda.is_available() is False (pass --device cpu for the CPU)")
        n = torch.cuda.device_count()
        names = sorted({torch.cuda.get_device_name(i) for i in range(n)})
        return _line(True, "cuda devices", f"{n}x {', '.join(names)} (CUDA {torch.version.cuda})")
    except Exception as e:  # noqa: BLE001
        return _line(False, "cuda devices", str(e))


def check_kernels(device: str) -> bool:
    """nvcc, and the three kernel libraries built from ``csrc/`` and bound."""
    if device == "cpu":
        return _line(True, "CUDA kernels", "skipped (--device cpu)")
    try:
        from dynamo_tpu_torch.ops import _build, paged_attention, ragged_attention

        nvcc = _build.nvcc_path()
        for d in ragged_attention.KERNEL_HEAD_DIMS:
            for int8 in (False, True):
                ragged_attention.bind(_build.load("ragged_paged_attention"), int8, d)
        for dtype in ragged_attention.GENERIC_Q_DTYPES:
            for int8 in (False, True):
                ragged_attention.bind_generic(_build.load("ragged_paged_attention_generic"),
                                              dtype, int8)
        paged_attention.bind(_build.load("paged_attention"))
        return _line(True, "CUDA kernels", f"{nvcc}; ragged_paged_attention.cu (K1, head_dim "
                     f"{' and '.join(map(str, ragged_attention.KERNEL_HEAD_DIMS))}), "
                     f"ragged_paged_attention_generic.cu (K1's generic instance) and "
                     f"paged_attention.cu (K2) built and loaded")
    except Exception as e:  # noqa: BLE001
        return _line(False, "CUDA kernels", str(e))


def check_native() -> bool:
    try:
        from dynamo_tpu_torch.llm.kv_router.native_radix import native_available

        if native_available():
            return _line(True, "native radix index (C++)")
        return _line(True, "native radix index", "unavailable; Python fallback active")
    except Exception as e:  # noqa: BLE001
        return _line(False, "native radix index", str(e))


def check_engine(device: str) -> bool:
    try:
        from dynamo_tpu_torch.engine.config import tiny_engine, tiny_model
        from dynamo_tpu_torch.engine.core import EngineCore
        from dynamo_tpu_torch.llm.protocols.common import (
            PreprocessedRequest,
            SamplingOptions,
            StopConditions,
        )
        from dynamo_tpu_torch.ops import ragged_attention

        name = "tiny model, f32, " + ("plain versions" if device == "cpu"
                                       else "K1's generic instance")
        core = EngineCore(tiny_model(), tiny_engine(), seed=0, device=device)
        core.add_request(
            PreprocessedRequest(
                model="doctor", token_ids=[1, 2, 3], request_id="doctor",
                sampling=SamplingOptions(temperature=0.0),
                stop=StopConditions(max_tokens=2),
            )
        )
        before = dict(ragged_attention.kernel_launches)
        toks = 0
        for _ in range(50):
            for _, out in core.step():
                toks += len(out.token_ids)
            if not core.has_work():
                break
        launches = sum(ragged_attention.kernel_launches.values()) - sum(before.values())
        ok = toks >= 2 and (device == "cpu" or launches > 0)
        return _line(ok, f"engine smoke ({name}, 2 tokens)",
                     f"{toks} tokens, K1 launches {launches}")
    except Exception as e:  # noqa: BLE001
        return _line(False, "engine smoke", str(e))


async def check_store(address: str | None) -> bool:
    if not address:
        return _line(True, "store", "skipped (no --store-address)")
    try:
        from dynamo_tpu_torch.llm.discovery import MODEL_ROOT
        from dynamo_tpu_torch.runtime.store.client import StoreClient

        client = await asyncio.wait_for(StoreClient.open(address), 5)
        entries = await client.kv_get_prefix(MODEL_ROOT + "/")
        instances = await client.kv_get_prefix("/dynamo/instances/")
        await client.close()
        return _line(
            True, "store", f"{address}: {len(entries)} models, {len(instances)} instances"
        )
    except Exception as e:  # noqa: BLE001
        return _line(False, f"store {address}", str(e))


def main() -> None:
    ap = argparse.ArgumentParser(description="dynamo-tpu environment doctor (PyTorch port)")
    ap.add_argument("--store-address", default=None)
    ap.add_argument("--skip-engine", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    ok = check_imports()
    ok &= check_cuda(args.device)
    ok &= check_kernels(args.device)
    ok &= check_native()
    if not args.skip_engine:
        ok &= check_engine(args.device)
    ok &= asyncio.run(check_store(args.store_address))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()

"""Multimodal encode worker: images in, embedding descriptors out.

The port's copy of ``dynamo_tpu/backends/encoder/main.py``, held to it by
``tests/test_torch_copies.py``.

A separate fleet turns image refs into embedding tensors and hands them to
LLM workers by descriptor: the tensor stays on the encoder until the
consumer pulls it over the data plane's ``embed_fetch`` endpoint. The
vision tower is the deterministic patch-embed projection of
``llm/multimodal.py``.

Run: ``python -m dynamo_tpu_torch.backends.encoder [--namespace dynamo]``
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import time
import uuid
from typing import Any, AsyncIterator

from dynamo_tpu_torch.runtime import Context, DistributedRuntime
from dynamo_tpu_torch.runtime.worker import dynamo_worker

log = logging.getLogger("dynamo_tpu.backends.encoder")

# Held tensors await their consumer at most this long.
HOLD_TTL_S = 120.0


async def run_encode_worker(
    runtime: DistributedRuntime,
    namespace: str = "dynamo",
    component: str = "encoder",
    served_event: asyncio.Event | None = None,
    stats_out: list | None = None,
) -> None:
    from dynamo_tpu_torch.llm.multimodal import image_bytes, patch_embed

    worker_id = runtime.primary_lease_id
    held: dict[str, tuple[float, Any]] = {}  # embed_id -> (deadline, ndarray)
    stats = {"encoded": 0, "fetched": 0, "expired": 0}
    if stats_out is not None:
        stats_out.append(stats)

    def sweep() -> None:
        now = time.monotonic()
        for eid in [e for e, (dl, _) in held.items() if dl < now]:
            held.pop(eid, None)
            stats["expired"] += 1

    async def encode_handler(request: Any, context: Context) -> AsyncIterator[Any]:
        sweep()
        ref = request["image"]
        hidden = int(request["hidden_size"])
        emb = await asyncio.to_thread(
            patch_embed, image_bytes(ref), hidden
        )
        eid = uuid.uuid4().hex
        held[eid] = (time.monotonic() + HOLD_TTL_S, emb)
        stats["encoded"] += 1
        yield {
            "embed_id": eid,
            "worker_id": worker_id,
            "shape": list(emb.shape),
            "dtype": "float32",
        }

    async def fetch_handler(request: Any, context: Context) -> AsyncIterator[Any]:
        sweep()
        item = held.pop(request["embed_id"], None)
        if item is None:
            yield {"error": f"no held embedding {request['embed_id']}"}
            return
        import numpy as np

        stats["fetched"] += 1
        yield {"data": np.ascontiguousarray(item[1]).tobytes()}

    comp = runtime.namespace(namespace).component(component)
    await comp.endpoint("encode").serve(encode_handler)
    await comp.endpoint("embed_fetch").serve(fetch_handler)
    log.info("encode worker %d ready (%s/%s)", worker_id, namespace, component)
    if served_event is not None:
        served_event.set()
    await runtime.wait_for_shutdown()


def main() -> None:
    ap = argparse.ArgumentParser(description="dynamo-tpu multimodal encode worker")
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--component", default="encoder")
    args = ap.parse_args()

    @dynamo_worker()
    async def entry(runtime: DistributedRuntime) -> None:
        await run_encode_worker(
            runtime, namespace=args.namespace, component=args.component
        )

    entry()


if __name__ == "__main__":
    main()

"""dynamo-tpu-run on the port: single-command serving for trials and smoke tests.

The port's counterpart of ``dynamo_tpu/run.py``: one process that embeds
the control-plane store, a worker for the chosen engine, and the chosen
input surface (``--in http|text|batch``, ``--out torch|mocker|echo|dyn://…``):

    python -m dynamo_tpu_torch.run --in http  --out mocker --http-port 8080
    python -m dynamo_tpu_torch.run --in text  --out torch --preset llama3-8b
    python -m dynamo_tpu_torch.run --in batch --out mocker --input prompts.jsonl

``--out torch`` starts the port's worker (``run_torch_worker``) on the card,
or with ``--device cpu`` on the plain versions; a model the card's
attention kernel cannot run (the f32 ``tiny`` presets) is refused on
``cuda`` before anything starts. ``--out dyn://namespace`` skips the
embedded worker and serves whatever workers are registered on an
external store (``--store-address``).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import sys
from pathlib import Path

import aiohttp

from dynamo_tpu_torch.runtime import DistributedRuntime
from dynamo_tpu_torch.runtime.store import StoreServer

log = logging.getLogger("dynamo_tpu_torch.run")


class _EchoEngine:
    """Streams the prompt's own tokens back — the zero-compute engine for
    pipeline smoke tests (parity: reference EchoFull, engines.rs:146)."""

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s

    async def generate(self, request: dict, context):
        from dynamo_tpu_torch.llm.protocols.common import LLMEngineOutput, PreprocessedRequest

        pre = PreprocessedRequest.from_wire(request)
        limit = pre.stop.max_tokens or len(pre.token_ids)
        toks = pre.token_ids[:limit]
        for i, tok in enumerate(toks):
            out = LLMEngineOutput(token_ids=[tok])
            if i == len(toks) - 1:
                out.finish_reason = "stop"
                out.prompt_tokens = len(pre.token_ids)
                out.completion_tokens = len(toks)
            yield out.to_wire()
            if self.delay_s:
                await asyncio.sleep(self.delay_s)


# Seconds an embedded worker may take to serve.
_SERVE_TIMEOUT_S = {"mocker": 60, "echo": 60, "torch": 900}


async def _start_worker(runtime, out_mode: str, args) -> None:
    served = asyncio.Event()
    if out_mode == "mocker":
        from dynamo_tpu_torch.backends.mocker.main import run_mocker
        from dynamo_tpu_torch.llm.mocker import MockEngineArgs

        task = asyncio.create_task(
            run_mocker(
                runtime,
                model_name=args.model_name,
                engine_args=MockEngineArgs(speedup_ratio=args.speedup_ratio),
                served_event=served,
            )
        )
    elif out_mode == "torch":
        from dynamo_tpu_torch.backends.torch.main import run_torch_worker

        task = asyncio.create_task(
            run_torch_worker(
                runtime,
                model_name=args.model_name,
                preset=args.preset,
                served_event=served,
                device=args.device,
            )
        )
    elif out_mode == "echo":
        from dynamo_tpu_torch.llm.discovery import register_llm
        from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

        engine = _EchoEngine()
        endpoint = runtime.namespace("dynamo").component("backend").endpoint("generate")

        async def handler(request, context):
            async for out in engine.generate(request, context):
                yield out

        await endpoint.serve(handler)
        await register_llm(
            endpoint,
            ModelDeploymentCard(
                name=args.model_name, tokenizer="byte", model_type="chat",
                context_length=8192, kv_block_size=32,
            ),
        )
        served.set()
        task = None
    else:
        raise ValueError(f"unknown out mode {out_mode!r}")
    # The torch worker builds and warms up its engine before it serves
    # (a minute or more at full width on the card); a worker that fails
    # first ends its task, whose error is raised here.
    waiter = asyncio.create_task(served.wait())
    pending = {waiter} | ({task} if task is not None else set())
    done, _ = await asyncio.wait(pending, timeout=_SERVE_TIMEOUT_S[out_mode],
                                 return_when=asyncio.FIRST_COMPLETED)
    if waiter not in done:
        waiter.cancel()
        if task is not None and task in done:
            task.result()
            raise RuntimeError(f"the {out_mode} worker ended before serving")
        raise TimeoutError(f"the {out_mode} worker did not serve within "
                           f"{_SERVE_TIMEOUT_S[out_mode]} s")
    return task


async def _serve_http(front_rt, args) -> None:
    from dynamo_tpu_torch.frontend.main import run_frontend

    await run_frontend(
        front_rt,
        http_host=args.http_host,
        http_port=args.http_port,
        router_mode=args.router_mode,
    )


async def _frontend_url(front_rt, args) -> tuple[asyncio.Task, str]:
    from dynamo_tpu_torch.frontend.main import run_frontend

    ready = asyncio.Event()
    services: list = []
    task = asyncio.create_task(
        run_frontend(
            front_rt, http_host="127.0.0.1", http_port=0,
            router_mode=args.router_mode, ready_event=ready, service_out=services,
        )
    )
    await asyncio.wait_for(ready.wait(), 30)
    url = f"http://127.0.0.1:{services[0].port}"
    async with aiohttp.ClientSession() as s:
        for _ in range(400):
            async with s.get(f"{url}/v1/models") as r:
                if (await r.json())["data"]:
                    return task, url
            await asyncio.sleep(0.05)
    raise TimeoutError("model never appeared on the embedded frontend")


async def _chat_once(url: str, model: str, content: str, max_tokens: int) -> str:
    async with aiohttp.ClientSession() as s:
        body = {
            "model": model,
            "messages": [{"role": "user", "content": content}],
            "max_tokens": max_tokens,
        }
        async with s.post(f"{url}/v1/chat/completions", json=body) as r:
            data = await r.json()
            if "error" in data:
                return f"[error] {data['error']['message']}"
            return data["choices"][0]["message"]["content"]


async def _amain(args) -> None:
    store = None
    store_address = args.store_address
    if store_address is None:
        store = StoreServer()
        await store.start()
        store_address = store.address

    runtimes = []
    worker_task = None
    try:
        if not args.out.startswith("dyn://"):
            worker_rt = await DistributedRuntime.create(store_address)
            runtimes.append(worker_rt)
            worker_task = await _start_worker(worker_rt, args.out, args)

        front_rt = await DistributedRuntime.create(store_address)
        runtimes.append(front_rt)

        if args.in_mode == "http":
            print(f"serving OpenAI API on http://{args.http_host}:{args.http_port}")
            await _serve_http(front_rt, args)
        elif args.in_mode == "text":
            _, url = await _frontend_url(front_rt, args)
            if args.prompt:
                print(await _chat_once(url, args.model_name, args.prompt, args.max_tokens))
            else:
                print("interactive mode — empty line exits")
                while True:
                    line = await asyncio.to_thread(input, "> ")
                    if not line.strip():
                        break
                    print(await _chat_once(url, args.model_name, line, args.max_tokens))
        elif args.in_mode == "batch":
            _, url = await _frontend_url(front_rt, args)
            raw = await asyncio.to_thread(Path(args.input).read_text)
            prompts = [json.loads(ln) for ln in raw.splitlines() if ln.strip()]
            out_fh = (
                await asyncio.to_thread(open, args.output, "w")
                if args.output else sys.stdout
            )
            for item in prompts:
                text = item["prompt"] if isinstance(item, dict) else str(item)
                reply = await _chat_once(url, args.model_name, text, args.max_tokens)
                out_fh.write(json.dumps({"prompt": text, "completion": reply}) + "\n")
            if args.output:
                out_fh.close()
        else:
            raise ValueError(f"unknown in mode {args.in_mode!r}")
    finally:
        for rt in runtimes:
            rt.signal_shutdown()
            try:
                await rt.shutdown()
            except Exception:  # noqa: BLE001 — best-effort teardown
                log.debug("runtime shutdown raced", exc_info=True)
        if worker_task is not None:
            # The worker logs its engine's counters as it stops.
            await asyncio.wait([worker_task], timeout=30)
        if store is not None:
            await store.stop()


def main() -> None:
    ap = argparse.ArgumentParser(description="dynamo-tpu single-command runner (PyTorch port)")
    ap.add_argument("--in", dest="in_mode", default="http", choices=["http", "text", "batch"])
    ap.add_argument("--out", default="mocker", help="mocker | torch | echo | dyn://<ns>")
    ap.add_argument("--model-name", default="model")
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--speedup-ratio", type=float, default=1.0)
    ap.add_argument("--router-mode", default="kv")
    ap.add_argument("--http-host", default="0.0.0.0")
    ap.add_argument("--http-port", type=int, default=8080)
    ap.add_argument("--store-address", default=None, help="external store (else embedded)")
    ap.add_argument("--prompt", default=None, help="in=text: one-shot prompt")
    ap.add_argument("--max-tokens", type=int, default=64)
    ap.add_argument("--input", default=None, help="in=batch: prompts JSONL")
    ap.add_argument("--output", default=None, help="in=batch: output JSONL")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="out=torch: the worker's device (cpu: the plain versions)")
    args = ap.parse_args()
    if args.out == "torch":
        from dynamo_tpu_torch.backends.torch.main import engine_configs, use_one_malloc_arena
        from dynamo_tpu_torch.engine.core import check_slice

        use_one_malloc_arena()  # before any thread: the worker's engine steps on one
        # Refused before the store or the worker starts.
        check_slice(*engine_configs(args.preset), device=args.device)
    logging.basicConfig(level=logging.INFO)
    asyncio.run(_amain(args))


if __name__ == "__main__":
    main()

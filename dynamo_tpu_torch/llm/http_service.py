"""OpenAI-compatible HTTP frontend: aiohttp + SSE streaming + metrics.

The port's copy of ``dynamo_tpu/llm/http_service.py``, held to it by
``tests/test_torch_copies.py``.

Routes: ``/v1/chat/completions``, ``/v1/completions``, ``/v1/models``,
``/health``, ``/live``, ``/metrics``. Streaming responses are SSE
(``data: {chunk}\\n\\n`` … ``data: [DONE]``); client disconnects cancel the
request all the way down to the worker (the data plane forwards the kill).

Frontend metrics (parity `lib/llm/src/http/service/metrics.rs:16,137-244`):
``dynamo_frontend_requests_total``, ``dynamo_frontend_inflight_requests``,
``dynamo_frontend_time_to_first_token_seconds``,
``dynamo_frontend_inter_token_latency_seconds``,
``dynamo_frontend_request_duration_seconds``.

Capability parity: reference `lib/llm/src/http/service/service_v2.rs:316`
(router build), `openai.rs` (handlers), `disconnect.rs`.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import time

from aiohttp import web
from pydantic import ValidationError

from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.llm.admission import (
    AdmissionConfig,
    AdmissionController,
    resolve_deadline,
)
from dynamo_tpu_torch.llm.model_manager import ModelManager, ServedModel
from dynamo_tpu_torch.llm.protocols.openai import (
    ChatCompletionRequest,
    ChatCompletionResponse,
    ChatChoice,
    ChatMessage,
    CompletionRequest,
    ModelInfo,
    ModelList,
    Usage,
    new_request_id,
)
from dynamo_tpu_torch.runtime import chaos
from dynamo_tpu_torch.runtime.component import NoInstancesError
from dynamo_tpu_torch.runtime.engine import DeadlineExceededError
from dynamo_tpu_torch.runtime.logging_setup import TRACEPARENT_HEADER, child_traceparent
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.status_server import _bind_store_gauges, control_plane_section

log = logging.getLogger("dynamo_tpu.http")

_TTFT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
_ITL_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)

# Inbound x-request-id values must be shaped like ids before we adopt them
# (they land in logs, traces, and the control-plane store): conservative
# charset, bounded length. Anything else gets a freshly minted id.
_CLIENT_RID_RE = re.compile(r"^[A-Za-z0-9._:\-]{1,128}$")

# Inbound x-tenant-id values key rate-limit buckets, scheduler fair
# queues, and per-tenant /metrics labels — same conservative validation;
# anything else maps to the default tenant rather than a 400 (a broken
# proxy header must not take traffic down).
_TENANT_RE = re.compile(r"^[A-Za-z0-9._:\-]{1,64}$")


class HttpService:
    def __init__(
        self,
        manager: ModelManager,
        host: str = "0.0.0.0",
        port: int = 8000,
        metrics: MetricsRegistry | None = None,
        tls_cert: str | None = None,
        tls_key: str | None = None,
        admission: AdmissionConfig | None = None,
        draining_fn=None,
    ):
        self.manager = manager
        self.host = host
        self.port = port
        self.metrics = metrics or MetricsRegistry()
        self.tls_cert = tls_cert
        self.tls_key = tls_key
        # Overload admission (ISSUE 10): per-tenant rate buckets + the
        # in-flight ceiling. Default config is fully open — admission is
        # opt-in via CLI/knobs, never a silent new rejection path.
        self.admission = AdmissionController(admission or AdmissionConfig())
        # Drain visibility (PR 6 satellite): when the runtime is
        # draining, /health flips to 503 "draining" so load balancers
        # stop routing here, and new LLM requests get a retryable 503.
        self._draining_fn = draining_fn or (lambda: False)
        self.app = web.Application()
        self.app.router.add_post("/v1/chat/completions", self.chat_completions)
        self.app.router.add_post("/v1/completions", self.completions)
        self.app.router.add_post("/v1/embeddings", self.embeddings)
        self.app.router.add_post("/v1/responses", self.responses)
        self.app.router.add_get("/v1/models", self.list_models)
        self.app.router.add_post("/clear_kv_blocks", self.clear_kv_blocks)
        self.app.router.add_get("/health", self.health)
        self.app.router.add_get("/live", self.live)
        self.app.router.add_get("/metrics", self.prometheus)
        self.app.router.add_get("/traces", self.traces)
        self.app.router.add_get("/fleet", self.fleet)
        self._runner: web.AppRunner | None = None
        # Fleet observability (ISSUE 13): hooks run before each /metrics
        # render (the embedded aggregator syncs its worker_id-labeled
        # series here), and fleet_fn serves the /fleet status payload
        # when an aggregator is attached (obs/service.attach_aggregator).
        self.before_metrics: list = []
        self.fleet_fn = None
        # Control-plane connectivity (ISSUE 15): when a store client is
        # bound (bind_store), /health reports degraded (200) while the
        # store is dark — cached models keep serving — and the store_*
        # gauges export on this frontend's /metrics.
        self.store = None
        # Client-supplied request ids currently in flight (duplicates get
        # a fresh mint; see _request_id).
        self._inflight_rids: set[str] = set()
        self._tracer = tracing.get_tracer("frontend")
        # Per-phase latency histograms (dynamo_trace_phase_duration_seconds)
        # land on the same registry the planner observer scrapes.
        tracing.get_collector().bind_metrics(self.metrics)

    async def start(self) -> None:
        ssl_ctx = None
        if self.tls_cert and self.tls_key:
            import ssl

            ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_ctx.load_cert_chain(self.tls_cert, self.tls_key)
        self._runner = web.AppRunner(self.app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port, ssl_context=ssl_ctx)
        await site.start()
        for addr in self._runner.addresses:  # resolve ephemeral port
            self.port = addr[1]
        log.info(
            "OpenAI frontend on %s://%s:%d",
            "https" if ssl_ctx else "http", self.host, self.port,
        )

    async def stop(self) -> None:
        if self._runner:
            await self._runner.cleanup()

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _error(status: int, message: str, err_type: str = "invalid_request_error"):
        return web.json_response(
            {"error": {"message": message, "type": err_type}}, status=status
        )

    @staticmethod
    def _validate_sampling(body) -> str | None:
        if body.max_tokens is not None and body.max_tokens < 1:
            return "max_tokens must be at least 1"
        mct = getattr(body, "max_completion_tokens", None)
        if mct is not None and mct < 1:
            return "max_completion_tokens must be at least 1"
        if body.temperature is not None and body.temperature < 0:
            return "temperature must be non-negative"
        if body.top_p is not None and not (0.0 < body.top_p <= 1.0):
            return "top_p must be in (0, 1]"
        if body.n < 1:
            return "n must be at least 1"
        if body.n > 1:
            return "n > 1 is not yet supported"
        return None

    def _lookup(self, model: str) -> ServedModel | None:
        return self.manager.get(model)

    def _headers_for(
        self, request: web.Request, request_id: str, span=None
    ) -> dict[str, str]:
        """Downstream dataplane headers: the request id plus a traceparent.
        With a live root span, downstream spans parent to IT; otherwise
        the pre-tracing behavior (a child of the client's traceparent, or
        a fresh trace) keeps log correlation working."""
        headers = {
            TRACEPARENT_HEADER: child_traceparent(request.headers.get(TRACEPARENT_HEADER)),
            "x-request-id": request_id,
        }
        if span is not None:
            tracing.inject_headers(span, headers)
        return headers

    def _request_id(self, request: web.Request, prefix: str) -> str:
        """Honor a well-formed inbound ``x-request-id`` (so client-side and
        server-side traces correlate); mint one otherwise. An adopted id
        that is still in flight gets a fresh mint instead — downstream
        state (engine queues, KV pulls) is keyed by request id, so two
        concurrent requests must never share one. Handlers release the id
        via :meth:`_release_request_id` when the request finishes."""
        client_rid = request.headers.get("x-request-id", "").strip()
        if _CLIENT_RID_RE.match(client_rid) and client_rid not in self._inflight_rids:
            self._inflight_rids.add(client_rid)
            return client_rid
        return new_request_id(prefix)

    def _release_request_id(self, rid: str) -> None:
        self._inflight_rids.discard(rid)

    # -- overload admission (ISSUE 10) -------------------------------------

    @staticmethod
    def _tenant(request: web.Request) -> str:
        """The validated x-tenant-id header, or "" (the default tenant).
        Malformed values degrade to default rather than 400 — tenancy is
        a fairness key, not an auth boundary."""
        raw = request.headers.get("x-tenant-id", "").strip()
        return raw if _TENANT_RE.match(raw) else ""

    def _shed(
        self,
        status: int,
        reason: str,
        message: str,
        model: str,
        endpoint: str,
        retry_after_s: float = 1.0,
    ) -> web.Response:
        """One typed, retryable rejection: OpenAI-style error body, a
        Retry-After header, and the frontend_requests_shed_total counter
        bumped under its reason label. Every overload path (rate limit,
        ceiling, worker shed, deadline, draining, chaos) exits here so
        clients see ONE error contract."""
        self.metrics.scoped(
            service="frontend", model=model, endpoint=endpoint, reason=reason
        ).counter(
            "frontend_requests_shed_total",
            "LLM requests rejected by overload protection, by reason",
        ).inc()
        err_type = {
            429: "rate_limit_error",
            503: "overloaded_error",
        }.get(status, "overloaded_error")
        if reason == "deadline":
            err_type = "deadline_exceeded"
        return web.json_response(
            {
                "error": {
                    "message": message,
                    "type": err_type,
                    "code": reason,
                    # Machine-readable mirror of Retry-After — shed
                    # responses are retryable BY CONTRACT.
                    "retryable": True,
                }
            },
            status=status,
            headers={"Retry-After": str(max(1, int(retry_after_s + 0.999)))},
        )

    async def _admission_gate(
        self, request: web.Request, model: str, endpoint: str,
        dyn_deadline_ms: float | None,
    ):
        """The ONE admission sequence every LLM endpoint runs: draining
        check, chaos ``frontend.admit`` point, deadline resolution,
        rate/ceiling decision. Returns a rejection ``web.Response``, or
        ``(tenant, deadline_ms, deadline_epoch)`` on admission — in
        which case the caller OWNS one in-flight slot and must pair with
        ``self.admission.release()``."""
        tenant = self._tenant(request)
        if self._draining_fn():
            return self._shed(
                503, "draining",
                "frontend is draining; retry against another replica",
                model, endpoint,
            )
        if chaos.active():
            # Overload chaos point: a plan can delay admission or shed
            # p% of requests (drop/sever both map to a clean 503) —
            # deterministic overload without touching client code.
            try:
                proceed = await chaos.inject(
                    "frontend.admit", f"{tenant or 'default'}/{model}"
                )
            except ConnectionError:
                proceed = False
            if not proceed:
                return self._shed(
                    503, "chaos", "request shed by the active chaos plan",
                    model, endpoint,
                )
        deadline_ms, deadline_epoch, err = resolve_deadline(
            dyn_deadline_ms, request.headers.get("x-request-deadline-ms")
        )
        if err is not None:
            return self._error(400, err)
        decision = self.admission.admit(tenant)
        if not decision.admitted:
            return self._shed(
                decision.status, decision.reason, decision.message,
                model, endpoint, decision.retry_after_s,
            )
        return tenant, deadline_ms, deadline_epoch

    # -- handlers ----------------------------------------------------------

    def bind_store(self, store) -> None:
        """Wire the control-plane client into /health + /metrics (the
        frontend twin of status_server.bind_store_gauges)."""
        self.store = store
        _bind_store_gauges(self.metrics, self.before_metrics, store)

    async def health(self, request: web.Request) -> web.Response:
        models = [s.entry.name for s in self.manager.list_models()]
        if self._draining_fn():
            # Draining (PR 6 SIGTERM path): new requests are being
            # refused, so the health probe must go dark — a 200 here
            # keeps load balancers routing into guaranteed rejections.
            return web.json_response(
                {"status": "draining", "models": models}, status=503
            )
        payload: dict = {
            "status": "healthy" if models else "starting", "models": models
        }
        if self.store is not None:
            payload["control_plane"], connected = control_plane_section(
                self.store
            )
            if models and not connected:
                # Degraded-mode serving (ISSUE 15): discovery is a cached
                # snapshot but requests still route — stay 200 so load
                # balancers keep sending traffic a blackout can't break.
                payload["status"] = "degraded"
        return web.json_response(payload)

    async def live(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "live"})

    async def prometheus(self, request: web.Request) -> web.Response:
        for hook in self.before_metrics:
            hook()
        return web.Response(body=self.metrics.render(), content_type="text/plain")

    async def fleet(self, request: web.Request) -> web.Response:
        """Fleet status page: live workers + per-tenant SLO breakdown
        (populated when the fleet aggregator is embedded)."""
        if self.fleet_fn is None:
            return web.json_response(
                {"error": "no fleet aggregator attached"}, status=404
            )
        return web.json_response(self.fleet_fn())

    async def traces(self, request: web.Request) -> web.Response:
        from dynamo_tpu_torch.runtime.status_server import render_traces

        return web.json_response(render_traces(request))

    async def list_models(self, request: web.Request) -> web.Response:
        out = ModelList(
            data=[
                ModelInfo(id=s.entry.name, max_model_len=s.mdc.context_length)
                for s in self.manager.list_models()
            ]
        )
        return web.json_response(out.model_dump())

    def _observe_isl(self, m, n_tokens: int):
        """Sequence-length metrics feed the SLA planner's observation loop
        (reference planner_core.py:180 observes these frontend series)."""
        m.histogram("frontend_input_sequence_tokens").observe(n_tokens)
        return lambda osl: m.histogram("frontend_output_sequence_tokens").observe(osl)

    async def chat_completions(self, request: web.Request) -> web.StreamResponse:
        def make_stream(served: ServedModel, body, rid: str, headers, m, stamp):
            pre = served.preprocessor.preprocess_chat(body)
            stamp(pre, rid)
            return served.preprocessor.postprocess_chat_stream(
                pre,
                served.generate(pre, headers),
                request_id=rid,
                include_usage=bool(body.stream_options and body.stream_options.include_usage)
                or not body.stream,
                on_complete=self._observe_isl(m, len(pre.token_ids)),
            )

        return await self._handle_llm_request(
            request, ChatCompletionRequest, "chatcmpl", "chat",
            make_stream, self._aggregate_chat,
        )

    async def completions(self, request: web.Request) -> web.StreamResponse:
        def make_stream(served: ServedModel, body, rid: str, headers, m, stamp):
            pre = served.preprocessor.preprocess_completion(body)
            stamp(pre, rid)
            return served.preprocessor.postprocess_completion(
                pre, served.generate(pre, headers), request_id=rid, stream=body.stream,
                on_complete=self._observe_isl(m, len(pre.token_ids)),
            )

        async def aggregate(rid, body, responses):
            final = None
            async for r in responses:
                final = r
            if final is None:
                return self._error(500, "engine returned no output", "internal_error")
            return web.json_response(final.model_dump())

        return await self._handle_llm_request(
            request, CompletionRequest, "cmpl", "completions", make_stream, aggregate
        )

    async def clear_kv_blocks(self, request: web.Request) -> web.Response:
        """Admin: drop unpinned KV cache blocks on every worker of every
        served model (reference http/service/clear_kv_blocks.rs). Workers
        fan out concurrently; a worker that errors OR answers without a
        count reports -1, so the response always covers the full fleet.

        Disaggregated deployments: prefill workers never register a served
        model, so they are reached through their component ("prefill" by
        convention) in each served namespace and reported under a
        ``prefill:{namespace}`` key."""

        async def clear_one(client, wid: int) -> int:
            try:
                stream = await client.direct(wid, {"clear_kv_blocks": True})
                async for out in stream:
                    if "cleared_blocks" in out:
                        return int(out["cleared_blocks"])
                return -1  # stream ended without a count: engine too old?
            except Exception:  # noqa: BLE001 — report the rest anyway
                log.exception("clear_kv_blocks failed for worker %d", wid)
                return -1

        results: dict[str, dict[str, int]] = {}
        namespaces: set[str] = set()
        for served in self.manager.list_models():
            namespaces.add(served.entry.namespace)
            wids = served.client.instance_ids()
            counts = await asyncio.gather(
                *(clear_one(served.client, w) for w in wids)
            )
            results[served.entry.name] = {
                str(w): c for w, c in zip(wids, counts)
            }
        async def clear_prefill_ns(ns: str) -> tuple[str, dict | None]:
            client = None
            try:
                endpoint = (
                    self.manager.runtime.namespace(ns)
                    .component("prefill")
                    .endpoint("generate")
                )
                # Cheap existence probe first: aggregated deployments have
                # no prefill instances registered, and must not pay a
                # client + watch + wait per admin call.
                registered = await self.manager.runtime.store.kv_get_prefix(
                    endpoint.instance_prefix
                )
                if not registered:
                    return ns, None
                client = await endpoint.client()
                # The instance watch populates asynchronously; the probe
                # above guarantees instances exist, so this is brief.
                try:
                    await client.wait_for_instances(1, timeout=5.0)
                except (asyncio.TimeoutError, TimeoutError):
                    pass
                wids = client.instance_ids()
                if not wids:
                    return ns, None
                counts = await asyncio.gather(
                    *(clear_one(client, w) for w in wids)
                )
                return ns, {str(w): c for w, c in zip(wids, counts)}
            except Exception:  # noqa: BLE001 — must stay visible, not a 200
                log.exception("prefill clear sweep failed in namespace %r", ns)
                return ns, {"error": -1}
            finally:
                if client is not None:
                    try:
                        await client.stop()
                    except Exception:  # noqa: BLE001 — keep partial results
                        log.warning("prefill clear client teardown failed")

        for ns, counts in await asyncio.gather(
            *(clear_prefill_ns(ns) for ns in sorted(namespaces))
        ):
            if counts is not None:
                results[f"prefill:{ns}"] = counts
        return web.json_response({"cleared": results})

    async def embeddings(self, request: web.Request) -> web.Response:
        """OpenAI /v1/embeddings: tokenize, one engine forward per input,
        mean-pooled hidden state (reference service_v2.rs:277-336)."""
        from dynamo_tpu_torch.llm.protocols.openai import EmbeddingRequest

        try:
            body = EmbeddingRequest.model_validate(await request.json())
        except (ValidationError, json.JSONDecodeError) as e:
            return self._error(400, f"invalid request: {e}")
        served = self._lookup(body.model)
        if served is None:
            return self._error(404, f"model {body.model!r} not found", "model_not_found")

        raw = body.input
        if isinstance(raw, str):
            inputs: list = [raw]
        elif raw and isinstance(raw[0], int):
            inputs = [raw]  # one pre-tokenized sequence
        else:
            inputs = list(raw)

        tok = served.preprocessor.tokenizer
        data = []
        total_tokens = 0
        rid = self._request_id(request, "embd")
        headers = self._headers_for(request, rid)
        try:
            for i, item in enumerate(inputs):
                token_ids = item if isinstance(item, list) else tok.encode(item)
                total_tokens += len(token_ids)
                stream = await served.client.round_robin(
                    {"embed": True, "token_ids": list(token_ids)}, headers
                )
                vec = None
                async for out in stream:
                    if "embedding" in out:
                        vec = out["embedding"]
                if vec is None:
                    return self._error(500, "engine returned no embedding", "internal_error")
                data.append({"object": "embedding", "index": i, "embedding": vec})
        except Exception as e:  # noqa: BLE001
            log.exception("embeddings request %s failed", rid)
            return self._error(500, str(e), "internal_error")
        finally:
            self._release_request_id(rid)
        return web.json_response(
            {
                "object": "list",
                "data": data,
                "model": body.model,
                "usage": {"prompt_tokens": total_tokens, "total_tokens": total_tokens},
            }
        )

    async def responses(self, request: web.Request) -> web.Response:
        """OpenAI /v1/responses (non-streaming): accepts string or
        message-list input, runs the chat pipeline, answers in Responses
        format (reference service_v2.rs:277-336)."""
        try:
            body_raw = await request.json()
        except json.JSONDecodeError as e:
            return self._error(400, f"invalid request: {e}")
        model = body_raw.get("model")
        raw_input = body_raw.get("input")
        if not model or raw_input is None:
            return self._error(400, "'model' and 'input' are required")
        if isinstance(raw_input, str):
            messages = [{"role": "user", "content": raw_input}]
        else:
            messages = [
                {"role": m.get("role", "user"), "content": m.get("content", "")}
                for m in raw_input
            ]
        chat_body = {
            "model": model,
            "messages": messages,
            "stream": False,
        }
        if body_raw.get("max_output_tokens") is not None:
            chat_body["max_tokens"] = body_raw["max_output_tokens"]
        for k in ("temperature", "top_p"):
            if body_raw.get(k) is not None:
                chat_body[k] = body_raw[k]
        if body_raw.get("dyn") is not None:
            # Extensions (deadline_ms, priority, ...) ride through to the
            # rebuilt chat request so this endpoint honors the same
            # overload contract as /v1/chat/completions.
            chat_body["dyn"] = body_raw["dyn"]
        try:
            body = ChatCompletionRequest.model_validate(chat_body)
        except ValidationError as e:
            return self._error(400, f"invalid request: {e}")
        served = self._lookup(model)
        if served is None:
            return self._error(404, f"model {model!r} not found", "model_not_found")
        # Same admission gate as the streaming endpoints: /v1/responses
        # must not be a side door around the rate limit, the drain, the
        # deadline contract, or the chaos overload point.
        gate = await self._admission_gate(
            request, model, "responses", body.dyn.deadline_ms
        )
        if isinstance(gate, web.Response):
            return gate
        tenant, deadline_ms, deadline_epoch = gate

        rid = self._request_id(request, "resp")
        text_parts: list[str] = []
        usage = None
        try:
            pre = served.preprocessor.preprocess_chat(body)
            pre.request_id = rid
            pre.tenant_id = tenant
            if deadline_ms is not None:
                pre.deadline_ms = deadline_ms
                pre.deadline_epoch = deadline_epoch
            chunks = served.preprocessor.postprocess_chat_stream(
                pre,
                served.generate(pre, self._headers_for(request, rid)),
                request_id=rid,
                include_usage=True,
            )
            async for chunk in chunks:
                for choice in chunk.choices:
                    if choice.delta.content:
                        text_parts.append(choice.delta.content)
                if chunk.usage:
                    usage = chunk.usage
        except DeadlineExceededError as e:
            return self._shed(503, "deadline", str(e), model, "responses")
        except (ConnectionError, NoInstancesError) as e:
            return self._shed(
                503, "worker_shed",
                f"no instance could take the request: {e}",
                model, "responses",
            )
        except Exception as e:  # noqa: BLE001
            log.exception("responses request %s failed", rid)
            return self._error(500, str(e), "internal_error")
        finally:
            self.admission.release()
            self._release_request_id(rid)
        return web.json_response(
            {
                "id": rid,
                "object": "response",
                "created_at": int(time.time()),
                "status": "completed",
                "model": model,
                "output": [
                    {
                        "type": "message",
                        "role": "assistant",
                        "status": "completed",
                        "content": [
                            {"type": "output_text", "text": "".join(text_parts)}
                        ],
                    }
                ],
                "usage": {
                    "input_tokens": usage.prompt_tokens if usage else 0,
                    "output_tokens": usage.completion_tokens if usage else 0,
                    "total_tokens": usage.total_tokens if usage else 0,
                },
            }
        )

    async def _handle_llm_request(
        self, request: web.Request, model_cls, rid_prefix: str, endpoint: str,
        make_stream, aggregate,
    ) -> web.StreamResponse:
        """The shared request lifecycle: parse/validate -> model lookup ->
        metrics bracketing -> stream (SSE) or aggregate -> error mapping.
        Chat and completions differ only in their pre/postprocess pair."""
        try:
            body = model_cls.model_validate(await request.json())
        except (ValidationError, json.JSONDecodeError) as e:
            return self._error(400, f"invalid request: {e}")
        if msg := self._validate_sampling(body):
            return self._error(400, msg)
        served = self._lookup(body.model)
        if served is None:
            return self._error(404, f"model {body.model!r} not found", "model_not_found")

        # -- admission gate (ISSUE 10): decide BEFORE any work is done --
        gate = await self._admission_gate(
            request, body.model, endpoint, body.dyn.deadline_ms
        )
        if isinstance(gate, web.Response):
            return gate
        tenant, deadline_ms, deadline_epoch = gate

        def stamp(pre, rid: str) -> None:
            """Identity + overload metadata onto the preprocessed
            request: the scheduler's fair queues and deadline sweeps key
            off these fields downstream."""
            pre.request_id = rid
            pre.tenant_id = tenant
            if deadline_ms is not None:
                pre.deadline_ms = deadline_ms
                pre.deadline_epoch = deadline_epoch

        rid = self._request_id(request, rid_prefix)
        m = self.metrics.scoped(service="frontend", model=body.model, endpoint=endpoint)
        m.counter("frontend_requests_total").inc()
        inflight = m.gauge("frontend_inflight_requests")
        inflight.inc()
        started = time.monotonic()
        # Root span of the request's trace: every downstream phase
        # (tokenize here; route/prefill/decode in other processes) parents
        # to it through the headers built below.
        root = self._tracer.span(
            "http",
            headers=request.headers,
            attrs={
                "request_id": rid, "endpoint": endpoint, "model": body.model,
                # Tenant identity on the trace: the SLO attributor keys
                # per-request budget breakdowns by it.
                "tenant": tenant or "default",
            },
        )
        try:
            with self._tracer.span("tokenize", parent=root):
                # make_stream runs the synchronous preprocess (chat
                # template + tokenize) before returning the lazy stream.
                chunks = make_stream(
                    served, body, rid, self._headers_for(request, rid, root), m, stamp
                )
            if body.stream:
                # Pull the FIRST chunk before sending SSE headers: a
                # pre-first-token rejection (queue-expired deadline,
                # fleet-wide shed) must surface as the typed 503 below,
                # not as an in-band error inside a 200 stream. Once a
                # token exists the request is admitted, and admitted
                # streams never shed — so errors after this point are
                # genuine mid-stream failures.
                chunks = chunks.__aiter__()
                try:
                    first_chunk = await chunks.__anext__()
                except StopAsyncIteration:
                    first_chunk = None
                return await self._stream_sse(
                    request, chunks, started, m, first_chunk
                )
            return await aggregate(rid, body, chunks)
        except asyncio.CancelledError:
            root.set("error", "cancelled")
            raise
        except DeadlineExceededError as e:
            # Queued past its deadline on a worker: typed, clean, and
            # retryable (with a fresh budget) — never a broken stream.
            root.set("error", "deadline_exceeded")
            return self._shed(503, "deadline", str(e), body.model, endpoint)
        except (ConnectionError, NoInstancesError) as e:
            # Every instance shed/drained/died and migration exhausted
            # its retries: the fleet is saturated, not broken — answer
            # the retryable overload shape, not a 500.
            root.set("error", "overloaded")
            return self._shed(
                503, "worker_shed",
                f"no instance could take the request: {e}",
                body.model, endpoint,
            )
        except Exception as e:  # noqa: BLE001 — surface engine errors as 500s
            log.exception("%s request %s failed", endpoint, rid)
            root.set("error", type(e).__name__)
            return self._error(500, str(e), "internal_error")
        finally:
            self.admission.release()
            self._release_request_id(rid)
            inflight.dec()
            m.histogram("frontend_request_duration_seconds").observe(
                time.monotonic() - started
            )
            root.finish()

    # -- response shaping --------------------------------------------------

    async def _stream_sse(
        self, request: web.Request, chunks, started: float, m, first_chunk=None
    ) -> web.StreamResponse:
        """``first_chunk`` was already pulled by the caller (inside its
        typed-error scope, BEFORE the 200 headers commit); it streams
        first, then the rest of ``chunks``."""

        async def with_first():
            if first_chunk is not None:
                yield first_chunk
            async for c in chunks:
                yield c

        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
            }
        )
        await resp.prepare(request)
        first = True
        last_t = None
        ttft_h = m.histogram("frontend_time_to_first_token_seconds", buckets=_TTFT_BUCKETS)
        itl_h = m.histogram("frontend_inter_token_latency_seconds", buckets=_ITL_BUCKETS)
        try:
            async for chunk in with_first():
                now = time.monotonic()
                if first:
                    ttft_h.observe(now - started)
                    first = False
                elif last_t is not None:
                    itl_h.observe(now - last_t)
                last_t = now
                payload = json.dumps(chunk.model_dump(exclude_none=True))
                await resp.write(f"data: {payload}\n\n".encode())
            await resp.write(b"data: [DONE]\n\n")
        except asyncio.CancelledError:
            raise
        except ConnectionResetError:
            pass  # client went away
        except Exception as e:  # noqa: BLE001 — headers already sent; error in-band
            log.exception("mid-stream failure")
            err = json.dumps({"error": {"message": str(e), "type": "internal_error"}})
            try:
                await resp.write(f"data: {err}\n\n".encode())
            except ConnectionResetError:
                pass
        try:
            await resp.write_eof()
        except ConnectionResetError:
            pass
        return resp

    async def _aggregate_chat(self, rid, body, chunks) -> web.Response:
        text_parts: list[str] = []
        finish = None
        usage = None
        lp_content: list[dict] = []
        created = int(time.time())
        async for chunk in chunks:
            for choice in chunk.choices:
                if choice.delta.content:
                    text_parts.append(choice.delta.content)
                if choice.logprobs and choice.logprobs.get("content"):
                    lp_content.extend(choice.logprobs["content"])
                if choice.finish_reason:
                    finish = choice.finish_reason
            if chunk.usage:
                usage = chunk.usage
        out = ChatCompletionResponse(
            id=rid,
            created=created,
            model=body.model,
            choices=[
                ChatChoice(
                    message=ChatMessage(role="assistant", content="".join(text_parts)),
                    finish_reason=finish or "stop",
                    logprobs={"content": lp_content} if lp_content else None,
                )
            ],
            usage=usage or Usage(),
        )
        return web.json_response(out.model_dump(exclude_none=True))

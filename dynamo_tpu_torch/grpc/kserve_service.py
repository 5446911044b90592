"""KServe v2 gRPC frontend over the model manager.

The port's copy of ``dynamo_tpu/grpc/kserve_service.py``, held to it by
``tests/test_torch_copies.py``.

ModelInfer (tensor-based text in and out), liveness, readiness and
metadata, behind the same discovery-fed ``ModelManager`` the HTTP
frontend uses. Messages come from protoc's python output
(``kserve_pb2.py``, held byte for byte with ``kserve.proto``), and the
service table is written by hand, one line per RPC. Needs ``grpcio``
and ``protobuf``; nothing else in the port imports this module.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

import grpc

sys.path.insert(0, str(Path(__file__).resolve().parent))  # kserve_pb2 import
from dynamo_tpu_torch.grpc import kserve_pb2 as pb  # noqa: E402
from dynamo_tpu_torch.llm.model_manager import ModelManager  # noqa: E402
from dynamo_tpu_torch.llm.protocols.openai import CompletionRequest, new_request_id  # noqa: E402

log = logging.getLogger("dynamo_tpu.grpc")

_SERVICE = "inference.GRPCInferenceService"


def _param(p: pb.InferParameter):
    which = p.WhichOneof("parameter_choice")
    return getattr(p, which) if which else None


class KserveGrpcService:
    def __init__(self, manager: ModelManager, host: str = "0.0.0.0", port: int = 0):
        self.manager = manager
        self.host = host
        self.port = port
        self._server: grpc.aio.Server | None = None

    async def start(self) -> None:
        server = grpc.aio.server()
        handlers = {
            "ServerLive": grpc.unary_unary_rpc_method_handler(
                self.server_live,
                request_deserializer=pb.ServerLiveRequest.FromString,
                response_serializer=pb.ServerLiveResponse.SerializeToString,
            ),
            "ServerReady": grpc.unary_unary_rpc_method_handler(
                self.server_ready,
                request_deserializer=pb.ServerReadyRequest.FromString,
                response_serializer=pb.ServerReadyResponse.SerializeToString,
            ),
            "ModelReady": grpc.unary_unary_rpc_method_handler(
                self.model_ready,
                request_deserializer=pb.ModelReadyRequest.FromString,
                response_serializer=pb.ModelReadyResponse.SerializeToString,
            ),
            "ModelMetadata": grpc.unary_unary_rpc_method_handler(
                self.model_metadata,
                request_deserializer=pb.ModelMetadataRequest.FromString,
                response_serializer=pb.ModelMetadataResponse.SerializeToString,
            ),
            "ModelInfer": grpc.unary_unary_rpc_method_handler(
                self.model_infer,
                request_deserializer=pb.ModelInferRequest.FromString,
                response_serializer=pb.ModelInferResponse.SerializeToString,
            ),
        }
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
        )
        self.port = server.add_insecure_port(f"{self.host}:{self.port}")
        await server.start()
        self._server = server
        log.info("KServe gRPC frontend on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server:
            await self._server.stop(grace=1.0)

    # -- RPCs --------------------------------------------------------------

    async def server_live(self, request, context) -> pb.ServerLiveResponse:
        return pb.ServerLiveResponse(live=True)

    async def server_ready(self, request, context) -> pb.ServerReadyResponse:
        return pb.ServerReadyResponse(ready=bool(self.manager.list_models()))

    async def model_ready(self, request, context) -> pb.ModelReadyResponse:
        return pb.ModelReadyResponse(ready=self.manager.get(request.name) is not None)

    async def model_metadata(self, request, context) -> pb.ModelMetadataResponse:
        served = self.manager.get(request.name)
        if served is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"model {request.name!r} not found")
        return pb.ModelMetadataResponse(
            name=request.name, versions=["1"], platform="dynamo-tpu"
        )

    async def model_infer(self, request: pb.ModelInferRequest, context) -> pb.ModelInferResponse:
        served = self.manager.get(request.model_name)
        if served is None:
            await context.abort(
                grpc.StatusCode.NOT_FOUND, f"model {request.model_name!r} not found"
            )
        text = None
        for tensor in request.inputs:
            if tensor.name == "text_input" and tensor.contents.bytes_contents:
                text = tensor.contents.bytes_contents[0].decode("utf-8")
                break
        if text is None:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, "missing 'text_input' BYTES tensor"
            )
        params = {k: _param(v) for k, v in request.parameters.items()}
        body = CompletionRequest(
            model=request.model_name,
            prompt=text,
            max_tokens=int(params.get("max_tokens", 64)),
            temperature=float(params.get("temperature", 1.0)),
            stream=False,
        )
        rid = request.id or new_request_id("grpc")
        pre = served.preprocessor.preprocess_completion(body)
        pre.request_id = rid
        final = None
        async for r in served.preprocessor.postprocess_completion(
            pre, served.generate(pre, None), request_id=rid, stream=False
        ):
            final = r
        if final is None:
            await context.abort(grpc.StatusCode.INTERNAL, "engine returned no output")
        out_text = final.choices[0].text if final.choices else ""
        resp = pb.ModelInferResponse(model_name=request.model_name, id=rid)
        tensor = resp.outputs.add()
        tensor.name = "text_output"
        tensor.datatype = "BYTES"
        tensor.shape.append(1)
        tensor.contents.bytes_contents.append(out_text.encode("utf-8"))
        return resp

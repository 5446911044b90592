"""The port's KServe gRPC frontend (``dynamo_tpu_torch/grpc``) in front of a
port mocker behind the port's ``ModelManager``: ``ServerLive``,
``ServerReady``, ``ModelReady``, ``ModelMetadata`` and ``ModelInfer``
answer as the JAX package's stack answers the same requests, byte for
byte. Both packages' ``kserve_pb2`` load into one process: they register
the same file, which protobuf takes as one descriptor."""

import asyncio
import importlib
from contextlib import suppress

import grpc

SERVICE = "inference.GRPCInferenceService"


def _method(channel, name, req_cls, resp_cls):
    return channel.unary_unary(
        f"/{SERVICE}/{name}",
        request_serializer=req_cls.SerializeToString,
        response_deserializer=resp_cls.FromString,
    )


def _infer_request(pb, model: str, text: bytes, max_tokens: int, rid: str):
    req = pb.ModelInferRequest(model_name=model, id=rid)
    tensor = req.inputs.add()
    tensor.name = "text_input"
    tensor.datatype = "BYTES"
    tensor.shape.append(1)
    tensor.contents.bytes_contents.append(text)
    req.parameters["max_tokens"].int64_param = max_tokens
    return req


async def _kserve_session(pkg: str) -> list:
    """One package's store, mocker worker, model manager and gRPC service;
    the answers to a fixed sequence of requests, serialized (or a status
    code for a refused one)."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    pb = mod("grpc.kserve_pb2")
    KserveGrpcService = mod("grpc.kserve_service").KserveGrpcService
    run_mocker = mod("backends.mocker").run_mocker
    MockEngineArgs = mod("llm.mocker").MockEngineArgs
    ModelManager = mod("llm.model_manager").ModelManager
    DistributedRuntime = mod("runtime").DistributedRuntime
    StoreServer = mod("runtime.store").StoreServer

    store = StoreServer()
    await store.start()
    worker_rt = await DistributedRuntime.create(store.address)
    front_rt = await DistributedRuntime.create(store.address)
    served = asyncio.Event()
    worker = asyncio.create_task(run_mocker(
        worker_rt, model_name="mock", engine_args=MockEngineArgs(speedup_ratio=200.0),
        served_event=served,
    ))
    await asyncio.wait_for(served.wait(), 10)
    manager = ModelManager(front_rt, router_mode="kv")
    await manager.start()
    for _ in range(100):
        if manager.list_models():
            break
        await asyncio.sleep(0.05)
    svc = KserveGrpcService(manager, host="127.0.0.1", port=0)
    await svc.start()
    answers = []
    try:
        async with grpc.aio.insecure_channel(f"127.0.0.1:{svc.port}") as ch:
            calls = [
                ("ServerLive", pb.ServerLiveRequest(), pb.ServerLiveResponse),
                ("ServerReady", pb.ServerReadyRequest(), pb.ServerReadyResponse),
                ("ModelReady", pb.ModelReadyRequest(name="mock"), pb.ModelReadyResponse),
                ("ModelReady", pb.ModelReadyRequest(name="nope"), pb.ModelReadyResponse),
                ("ModelMetadata", pb.ModelMetadataRequest(name="mock"), pb.ModelMetadataResponse),
                ("ModelMetadata", pb.ModelMetadataRequest(name="nope"), pb.ModelMetadataResponse),
                ("ModelInfer", _infer_request(pb, "mock", b"hello kserve", 6, "t1"),
                 pb.ModelInferResponse),
                ("ModelInfer", _infer_request(pb, "mock", "héllo ünicode".encode(), 30,
                                              "t2"), pb.ModelInferResponse),
                ("ModelInfer", _infer_request(pb, "nope", b"x", 2, "t3"), pb.ModelInferResponse),
            ]
            for name, req, resp_cls in calls:
                try:
                    resp = await _method(ch, name, type(req), resp_cls)(req)
                    answers.append((name, resp.SerializeToString(deterministic=True)))
                except grpc.aio.AioRpcError as e:
                    answers.append((name, e.code(), e.details()))
    finally:
        await svc.stop()
        await manager.stop()
        for rt in (front_rt, worker_rt):
            rt.signal_shutdown()
        worker.cancel()
        for rt in (front_rt, worker_rt):
            with suppress(ConnectionError, OSError):
                await rt.shutdown()
        await store.stop()
    return answers


async def test_kserve_grpc_matches_jax_stack():
    got = await _kserve_session("dynamo_tpu_torch")
    want = await _kserve_session("dynamo_tpu")
    assert got == want
    from dynamo_tpu_torch.grpc import kserve_pb2 as pb

    by_name = {}
    for a in got:
        by_name.setdefault(a[0], []).append(a)
    assert pb.ServerLiveResponse.FromString(by_name["ServerLive"][0][1]).live
    assert pb.ServerReadyResponse.FromString(by_name["ServerReady"][0][1]).ready
    ready, missing = by_name["ModelReady"]
    assert pb.ModelReadyResponse.FromString(ready[1]).ready
    assert not pb.ModelReadyResponse.FromString(missing[1]).ready
    meta, meta_missing = by_name["ModelMetadata"]
    assert pb.ModelMetadataResponse.FromString(meta[1]).name == "mock"
    assert meta_missing[1] == grpc.StatusCode.NOT_FOUND
    infer, long_infer, infer_missing = by_name["ModelInfer"]
    resp = pb.ModelInferResponse.FromString(infer[1])
    assert resp.model_name == "mock" and resp.id == "t1"
    assert resp.outputs[0].name == "text_output"
    assert resp.outputs[0].contents.bytes_contents[0] == b"abcdef"  # the mocker's text
    assert len(pb.ModelInferResponse.FromString(long_infer[1])
               .outputs[0].contents.bytes_contents[0]) == 30
    assert infer_missing[1] == grpc.StatusCode.NOT_FOUND


def test_pb2_modules_share_one_descriptor():
    from dynamo_tpu.grpc import kserve_pb2 as jpb
    from dynamo_tpu_torch.grpc import kserve_pb2 as tpb

    assert tpb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    req = tpb.ModelInferRequest(model_name="m", id="x")
    assert jpb.ModelInferRequest.FromString(req.SerializeToString()).model_name == "m"

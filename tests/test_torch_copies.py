"""The port keeps its own copies of jax-free modules of the JAX package.
Each copy is held to its original: the code (everything but the module
docstring) parses to the same syntax tree, apart from the package name in
its imports, and the block hashes it computes are the same. Where the port
copies only the jax-free definitions of a module (``engine/kv_quant.py``),
each copied definition parses to the same tree as its original."""

import ast
from pathlib import Path

import numpy as np
import pytest

from dynamo_tpu.tokens import blocks as jblocks
from dynamo_tpu_torch.tokens import blocks as tblocks

ROOT = Path(__file__).resolve().parents[1]

COPIES = [
    "engine/block_allocator.py",
    "engine/fair_queue.py",
    "llm/protocols/common.py",
    "tokens/blocks.py",
    # The worker's control plane.
    "knobs.py",
    "runtime/tasks.py",
    "runtime/framing.py",
    "runtime/wire.py",
    "runtime/chaos.py",
    "runtime/engine.py",
    "runtime/logging_setup.py",
    "runtime/config.py",
    "runtime/store/client.py",
    "runtime/store/server.py",
    "runtime/store/__init__.py",
    "runtime/store/__main__.py",
    "runtime/dataplane.py",
    "obs/flight_recorder.py",
    "tracing/core.py",
    "tracing/__init__.py",
    "runtime/component.py",
    "runtime/worker.py",
    "runtime/__init__.py",
    "llm/model_card.py",
    "llm/discovery.py",
    "llm/kv_router/protocols.py",
    "llm/kv_router/publisher.py",
    "llm/tokenizer.py",
    # The status server and the obs snapshots.
    "runtime/metrics.py",
    "runtime/status_server.py",
    "obs/slo.py",
    "obs/snapshot.py",
    # The frontend's request path.
    "llm/protocols/openai.py",
    "llm/detokenizer.py",
    "llm/preprocessor.py",
    "llm/multimodal.py",
    # The KV router.
    "llm/kv_pool/__init__.py",
    "llm/kv_pool/global_index.py",
    "llm/kv_pool/peer_client.py",
    "llm/kv_router/indexer.py",
    "llm/kv_router/native_radix.py",
    "llm/kv_router/scheduler.py",
    "llm/kv_router/sequence.py",
    "llm/kv_router/netcost.py",
    "llm/kv_router/replica_sync.py",
    "llm/kv_router/router.py",
    "llm/kv_router/__init__.py",
    # The service pipeline, the HTTP service and the fleet aggregator.
    "runtime/pipeline.py",
    "runtime/worker_monitor.py",
    "llm/migration.py",
    "llm/admission.py",
    "llm/model_manager.py",
    "llm/http_service.py",
    "obs/aggregator.py",
    "obs/service.py",
    "obs/__init__.py",
    # The frontend process.
    "frontend/__init__.py",
    "frontend/__main__.py",
    "frontend/main.py",
    # Speculative decoding.
    "spec/__init__.py",
    "spec/config.py",
    "spec/ngram.py",
    "spec/stats.py",
    # KV tiers, transfer and disaggregation.
    "engine/host_cache.py",
    "engine/offload.py",
    "llm/disagg/__init__.py",
    "llm/disagg/router.py",
    "llm/disagg/target.py",
    "llm/disagg_pool/__init__.py",
    "llm/disagg_pool/cursor.py",
    "llm/disagg_pool/handoff.py",
    # The multimodal encode worker.
    "backends/encoder/__init__.py",
    "backends/encoder/__main__.py",
    "backends/encoder/main.py",
]


def _code_tree(path: Path, package: str) -> str:
    tree = ast.parse(path.read_text())
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]  # the module docstring says which copy it is
    tree = ast.Module(body=body, type_ignores=[])
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = node.module.replace(package, "PKG", 1)
    return ast.dump(tree)


# Definitions the port copies out of a module it otherwise rewrites.
COPIED_DEFINITIONS = [
    ("engine/kv_quant.py", name)
    for name in (
        "KV_DTYPES", "SCALE_BYTES", "_SCALE_FLOOR", "kv_page_bytes",
        "kv_byte_ratio", "pack_kv_page", "unpack_kv_page",
    )
]


def _definition(path: Path, name: str) -> str:
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return ast.dump(node)
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name for t in node.targets
        ):
            return ast.dump(node)
    raise AssertionError(f"{name} is not defined at the top of {path}")


@pytest.mark.parametrize("rel, name", COPIED_DEFINITIONS, ids=[n for _, n in COPIED_DEFINITIONS])
def test_copied_definition_matches_original(rel, name):
    assert _definition(ROOT / "dynamo_tpu_torch" / rel, name) == _definition(
        ROOT / "dynamo_tpu" / rel, name
    )


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_original(rel):
    assert _code_tree(ROOT / "dynamo_tpu_torch" / rel, "dynamo_tpu_torch") == _code_tree(
        ROOT / "dynamo_tpu" / rel, "dynamo_tpu"
    )


@pytest.mark.parametrize("block_size", [1, 4, 16, 32, 64])
def test_block_hashes_match(block_size):
    rng = np.random.default_rng(block_size)
    tokens = [int(t) for t in rng.integers(0, 2**31, 5 * block_size + 3)]
    assert tblocks.compute_seq_hashes(tokens, block_size) == jblocks.compute_seq_hashes(
        tokens, block_size
    )
    t_seq = tblocks.TokenBlockSequence(tokens, block_size)
    j_seq = jblocks.TokenBlockSequence(tokens, block_size)
    assert t_seq.block_hashes == j_seq.block_hashes
    assert t_seq.partial_tokens == j_seq.partial_tokens

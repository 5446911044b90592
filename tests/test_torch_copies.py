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
]


def _code_tree(path: Path, package: str) -> str:
    tree = ast.parse(path.read_text())
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]  # the module docstring says which copy it is
    for node in ast.walk(ast.Module(body=body, type_ignores=[])):
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = node.module.replace(package, "PKG", 1)
    return ast.dump(ast.Module(body=body, type_ignores=[]))


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

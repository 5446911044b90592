"""The port imports neither jax nor anything of the JAX package, and its
entry points refuse what the slice does not serve."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# Everything that runs on a machine with PyTorch and no jax.
PORT_FILES = sorted((ROOT / "dynamo_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "tests" / "test_torch_kernels_cuda.py",
]
FORBIDDEN = ("jax", "jaxlib", "dynamo_tpu")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_cpu_engine_leaves_jax_unimported():
    code = (
        "import sys\n"
        "from dynamo_tpu_torch.backends.torch.main import build_engine\n"
        "from dynamo_tpu_torch.engine.core import EngineCore\n"
        "import dynamo_tpu_torch.runtime, dynamo_tpu_torch.runtime.store\n"
        "import dynamo_tpu_torch.llm.discovery, dynamo_tpu_torch.llm.kv_router\n"
        "import dynamo_tpu_torch.llm.tokenizer, dynamo_tpu_torch.obs.flight_recorder\n"
        "import dynamo_tpu_torch.backends.torch.main, dynamo_tpu_torch.frontend.main\n"
        "import dynamo_tpu_torch.llm.kv_router.native_radix, dynamo_tpu_torch.llm.kv_pool\n"
        "core, engine = build_engine('tiny', device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dynamo_tpu')]\n"
        "print('LEAKED', bad) if bad else print('CLEAN')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "CLEAN", out.stdout


@pytest.mark.parametrize(
    "overrides, item",
    [
        ({"scheduling": "chunked"}, "A8b"),
        ({"disk_kv_dir": "kv"}, "A10"),
        ({"spec_decode": "ngram"}, "A8c"),
        ({"kv_dtype": "int8", "host_kv_blocks": 16}, "A10"),
        ({"host_kv_blocks": 16}, "A10"),
        ({"ring_prefill_threshold": 64}, "A12"),
    ],
)
def test_unported_settings_refused(overrides, item):
    from dynamo_tpu_torch.backends.torch.main import build_engine

    with pytest.raises(ValueError, match=item):
        build_engine("tiny", overrides, device="cpu")


def test_unknown_kv_dtype_and_quant_refused():
    from dynamo_tpu_torch.backends.torch.main import build_engine

    with pytest.raises(ValueError, match="unknown kv_dtype"):
        build_engine("tiny", {"kv_dtype": "fp8"}, device="cpu")
    with pytest.raises(ValueError, match="unknown quantization"):
        build_engine("tiny", device="cpu", quant="int4")


def test_unported_models_and_meshes_refused():
    from dynamo_tpu_torch.backends.torch.main import build_engine
    from dynamo_tpu_torch.engine.config import tiny_engine, tiny_model
    from dynamo_tpu_torch.engine.core import EngineCore

    with pytest.raises(ValueError, match="A11"):
        build_engine("tiny-moe", device="cpu")
    with pytest.raises(ValueError, match="A12"):
        EngineCore(tiny_model(), tiny_engine(), device="cpu", mesh=object())


def test_cuda_entry_point_never_falls_back_to_cpu(monkeypatch):
    import torch

    from dynamo_tpu_torch.backends.torch.main import build_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_engine("tiny")

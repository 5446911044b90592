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


def _port_modules_named(path: Path) -> set[str]:
    """Every ``dynamo_tpu_torch`` module an import in ``path`` names (for
    ``from M import x``, the module M)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return {n for n in names if n.split(".")[0] == "dynamo_tpu_torch"}


@pytest.mark.parametrize(
    "path", PORT_FILES + sorted((ROOT / "tests").glob("test_torch_*.py")),
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_imports_resolve(path):
    """Each port module that an import names is a file of the port, as a
    module or a package: an import inside a function body fails only
    when it runs, so a missing module would otherwise show only there."""
    for name in _port_modules_named(path):
        base = ROOT.joinpath(*name.split("."))
        assert base.with_suffix(".py").is_file() or (base / "__init__.py").is_file(), name


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
        "import dynamo_tpu_torch.llm.disagg, dynamo_tpu_torch.llm.disagg_pool\n"
        "import dynamo_tpu_torch.engine.host_cache, dynamo_tpu_torch.engine.offload\n"
        "import dynamo_tpu_torch.engine.loader, dynamo_tpu_torch.engine.gguf\n"
        "import dynamo_tpu_torch.planner, dynamo_tpu_torch.planner.observer\n"
        "import dynamo_tpu_torch.planner.connector, dynamo_tpu_torch.obs.__main__\n"
        "import dynamo_tpu_torch.runtime.barrier, dynamo_tpu_torch.llm.kv_router.recorder\n"
        "import dynamo_tpu_torch.llm.parsers\n"
        "import dynamo_tpu_torch.llm.mocker, dynamo_tpu_torch.backends.mocker.main\n"
        "import dynamo_tpu_torch.fleet, dynamo_tpu_torch.run, dynamo_tpu_torch.check\n"
        "import dynamo_tpu_torch.grpc.kserve_service\n"
        "import tempfile\n"
        "core, engine = build_engine('tiny', {'host_kv_blocks': 8, 'disk_kv_dir': "
        "tempfile.mkdtemp()}, device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dynamo_tpu')]\n"
        "print('LEAKED', bad) if bad else print('CLEAN')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "CLEAN", out.stdout


@pytest.mark.parametrize(
    "overrides, refusal",
    [
        ({"disk_kv_dir": "kv"}, r"disk_kv_dir \(G3\) requires host_kv_blocks > 0 \(G2\)"),
        ({"kv_dtype": "int8", "host_kv_blocks": 16}, None),
        ({"host_kv_blocks": 16}, None),
        ({"ring_prefill_threshold": 64}, "A12"),
    ],
    ids=["overrides0-A10", "overrides1-A10", "overrides2-A10", "overrides3-A12"],
)
def test_unported_settings_refused(overrides, refusal, tmp_path):
    """What the slice does not serve is refused by the ROADMAP item that
    brings it. The host KV tier (A10) is served: those settings build an
    engine with the tier, and a disk directory without a host tier is
    refused with the JAX engine's message."""
    from dynamo_tpu_torch.backends.torch.main import build_engine

    if refusal is not None:
        with pytest.raises(ValueError, match=refusal):
            build_engine("tiny", overrides, device="cpu")
        return
    core, _ = build_engine("tiny", overrides, device="cpu")
    assert core.host_pool is not None and core.host_pool.capacity == 16
    assert core.allocator.on_evict == core._offload_block
    assert core.engine.kv_dtype == overrides.get("kv_dtype", "bf16")


@pytest.mark.parametrize(
    "overrides",
    [
        {"scheduling": "chunked", "spec_decode": "ngram"},
        {"spec_decode": "ngram"},
        {"spec_decode": "ngram", "spec_k": 2},
        {"spec_decode": "ngram", "spec_device_draft": True},
    ],
    ids=["chunked-ngram", "ngram", "ngram-k2", "ngram-device"],
)
def test_spec_settings_build_and_serve(overrides):
    """Speculative decoding (ROADMAP.md A8c) is served: each setting builds
    an engine that drafts on a quoting prompt and emits the stream of the
    same engine without speculation."""
    from dynamo_tpu_torch.backends.torch.main import build_engine
    from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

    req = {"model": "tiny", "token_ids": [5, 6, 7, 8] * 6, "request_id": "r",
           "sampling": {"temperature": 0.0}, "stop": {"max_tokens": 40, "ignore_eos": True}}
    streams = []
    for ov in (overrides, {k: v for k, v in overrides.items() if not k.startswith("spec_")}):
        core, _ = build_engine("tiny", ov, device="cpu")
        core.add_request(PreprocessedRequest.from_wire(req))
        toks = []
        while core.has_work():
            for _, out in core.step():
                toks += out.token_ids
        streams.append(toks)
        if ov is overrides:
            assert core.spec_decode_stats()["drafted_tokens"] > 0
    assert streams[0] == streams[1] and len(streams[0]) == 40


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

    # MoE presets are served (A11): tiny-moe builds.
    core, _ = build_engine("tiny-moe", device="cpu")
    assert core.cfg.is_moe and "w_router" in core.params["layers"]
    with pytest.raises(ValueError, match="A12"):
        EngineCore(tiny_model(), tiny_engine(), device="cpu", mesh=object())


def test_cuda_entry_point_never_falls_back_to_cpu(monkeypatch):
    import torch

    from dynamo_tpu_torch.backends.torch.main import build_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_engine("tiny")

"""Per-slot int8 KV quantization: layout, scales, and the canonical
packed page representation.

Counterpart of ``dynamo_tpu/engine/kv_quant.py``. Every K/V row is
quantized symmetrically per (token slot, combined head), amax over
``head_dim``, exactly once: when the forward pass writes it into its page
(``model.write_kv``). A quantized layer cache is ``{"kv": int8 [n_pages,
ps, 2*n_kv, d], "scale": f32 [n_pages, ps, 2*n_kv]}``; the per-layer tuple
is unchanged, each element just becomes this dict.

:func:`quantize_kv` and :func:`dequantize_kv` are the JAX functions in
torch, with the same f32 arithmetic (amax / 127, the 1e-8 floor,
round-half-even, clip to +-127): identical input rows give identical int8
bytes and scales. The one subtlety is the ``/ 127``: XLA compiles a
division by a constant as a product with its f32 reciprocal, and the JAX
engine's write runs compiled, so the port multiplies by ``f32(1/127)``
(an eager, uncompiled ``jnp`` division rounds differently in ~4% of
scales). Everything from ``KV_DTYPES`` on is a verbatim copy of
the jax-free part of the JAX module (``tests/test_torch_copies.py`` holds
each definition to its original). The host/disk tiers and transfers that
move packed pages are not ported yet (ROADMAP.md A10).
"""

from __future__ import annotations

import numpy as np
import torch

KV_DTYPES = ("bf16", "int8")

# f32 scale per (slot, combined head).
SCALE_BYTES = 4

# Guard against zero rows (all-zero K/V quantizes to zeros with this
# floor instead of dividing by zero).
_SCALE_FLOOR = 1e-8


# f32(1/127): the product XLA compiles ``amax / 127.0`` into.
INV_127 = float(np.float32(1.0 / 127.0))


def quantize_kv(kvn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize interleaved K/V rows ``[..., 2*n_kv, d]``.

    Returns ``(int8 [..., 2*n_kv, d], f32 scales [..., 2*n_kv])`` with
    symmetric per-(row, head) scales: ``kv ~= q * scale[..., None]``.
    """
    kv32 = kvn.float()
    scale = kv32.abs().amax(dim=-1) * INV_127
    scale = torch.clamp_min(scale, _SCALE_FLOOR)
    q = torch.clamp(torch.round(kv32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: f32 ``q * scale``."""
    return q.float() * scale[..., None]


def kv_page_bytes(
    num_layers: int, block_size: int, num_kv_heads: int, head_dim: int,
    kv_dtype: str, model_itemsize: int = 2,
) -> int:
    """Total bytes one KV block occupies across all layers, scale
    metadata included — the capacity denominator (``HBM budget // this``
    = resident blocks) and the /metrics bytes-per-block gauge."""
    slots = num_layers * block_size * 2 * num_kv_heads
    if kv_dtype == "int8":
        return slots * (head_dim + SCALE_BYTES)
    return slots * head_dim * model_itemsize


def kv_byte_ratio(kv_dtype: str, head_dim: int = 128, model_itemsize: int = 2) -> float:
    """Bytes moved per KV element relative to the bf16 page (scales
    included): 1.0 for bf16, ``(d + 4) / (2 d)`` ~= 0.516 for int8 at
    head_dim 128. The mocker prices decode KV traffic with this."""
    if kv_dtype == "int8":
        return (head_dim + SCALE_BYTES) / (head_dim * model_itemsize)
    return 1.0


# -- canonical host/wire packing --------------------------------------------

def pack_kv_page(kv_int8: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Pack one block's quantized page into the canonical 1-D uint8
    buffer: int8 kv bytes ``[L, ps, 2kv, d]`` then f32 scale bytes
    ``[L, ps, 2kv]``. Every tier and transfer stores/ships this buffer
    verbatim (quantize once — the bytes never change after the write)."""
    kv_b = np.ascontiguousarray(kv_int8, dtype=np.int8).view(np.uint8).reshape(-1)
    sc_b = (
        np.ascontiguousarray(scales, dtype=np.float32).view(np.uint8).reshape(-1)
    )
    return np.concatenate([kv_b, sc_b])


def unpack_kv_page(
    buf: np.ndarray | bytes, num_layers: int, block_size: int,
    num_kv_heads: int, head_dim: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`pack_kv_page`: returns ``(int8 [L, ps, 2kv, d],
    f32 scales [L, ps, 2kv])`` views over the buffer."""
    raw = (
        np.frombuffer(bytes(buf), np.uint8)
        if isinstance(buf, (bytes, bytearray))
        else np.asarray(buf, np.uint8)  # dynalint: sync-ok — packed host buffer, not a device array
    )
    comb = 2 * num_kv_heads
    kv_n = num_layers * block_size * comb * head_dim
    sc_n = num_layers * block_size * comb * SCALE_BYTES
    if raw.size != kv_n + sc_n:
        raise ValueError(
            f"packed int8 KV page of {raw.size} bytes does not match the "
            f"local geometry ({kv_n} kv + {sc_n} scale bytes); "
            "mixed-geometry transfer?"
        )
    kv = raw[:kv_n].view(np.int8).reshape(num_layers, block_size, comb, head_dim)
    scales = raw[kv_n:].view(np.float32).reshape(num_layers, block_size, comb)
    return kv, scales

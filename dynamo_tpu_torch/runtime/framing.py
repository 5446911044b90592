"""Wire framing for all dynamo_tpu TCP planes.

The port's copy of ``dynamo_tpu/runtime/framing.py``, held to it by
``tests/test_torch_copies.py``.

Every control-plane and data-plane connection speaks the same codec:
a 4-byte big-endian length prefix followed by one msgpack-encoded message.
Messages are dicts with short keys; the per-plane key constants and
schemas live in :mod:`dynamo_tpu.runtime.wire`.

Capability parity: reference `lib/runtime/src/pipeline/network/codec/
two_part.rs` (TwoPartMessage: control header + payload in one frame). We get
the same two-part shape by carrying ``h`` (header/control) and ``p``
(payload bytes) keys inside a single msgpack map, so the payload bytes are
never re-encoded — msgpack bin passes them through.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any

import msgpack

from dynamo_tpu_torch.runtime import chaos

_LEN = struct.Struct(">I")

MAX_FRAME = 512 * 1024 * 1024  # 512 MiB hard cap (KV block transfers are big)


def pack(msg: Any) -> bytes:
    body = msgpack.packb(msg, use_bin_type=True)
    return _LEN.pack(len(body)) + body


async def read_frame(reader: asyncio.StreamReader) -> Any:
    """Read one frame; raises IncompleteReadError / ConnectionError on EOF."""
    while True:
        header = await reader.readexactly(4)
        (length,) = _LEN.unpack(header)
        if length > MAX_FRAME:
            raise ValueError(f"frame of {length} bytes exceeds MAX_FRAME")
        body = await reader.readexactly(length)
        msg = msgpack.unpackb(body, raw=False)
        # Codec-level chaos (every plane): a dropped frame is read and
        # discarded, so the stream stays framed; sever raises here.
        if chaos.active() and not await chaos.inject("framing.recv"):
            continue
        return msg


def write_frame(writer: asyncio.StreamWriter, msg: Any) -> None:
    writer.write(pack(msg))


async def send_frame(writer: asyncio.StreamWriter, msg: Any) -> None:
    if chaos.active() and not await chaos.inject("framing.send"):
        return  # dropped by the active chaos plan
    writer.write(pack(msg))
    await writer.drain()

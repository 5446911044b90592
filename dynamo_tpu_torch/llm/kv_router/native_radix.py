"""ctypes bridge to the C++ radix prefix index (native/radix_tree.cpp).

The port's copy of ``dynamo_tpu/llm/kv_router/native_radix.py``, held to it by
``tests/test_torch_copies.py``.

Presents the same interface as the pure-Python RadixTree so KvIndexer can
swap implementations. The .so builds on demand with g++ (cached beside the
sources); if the toolchain or binary is unavailable, callers fall back to
Python (`native_available()`).

Why ctypes: a C ABI + ctypes keeps the native boundary dependency-free
(no pybind11).
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
import threading
from pathlib import Path

import numpy as np

from dynamo_tpu_torch.llm.kv_router.protocols import KvCacheEvent, RouterEvent

log = logging.getLogger("dynamo_tpu.native")

_NATIVE_DIR = Path(__file__).resolve().parents[3] / "native"
_SO = _NATIVE_DIR / "libdynamo_native.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False

_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _load() -> ctypes.CDLL | None:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            # Always invoke make: the Makefile is dependency-driven, so a
            # fresh .so is a no-op and a stale one (edited .cpp) rebuilds.
            # A failed make (no toolchain / stripped sources) still falls
            # through to CDLL when a prebuilt .so is present.
            try:
                subprocess.run(
                    ["make", "-C", str(_NATIVE_DIR)],
                    check=True, capture_output=True, timeout=120,
                )
            except (OSError, subprocess.SubprocessError) as e:
                if not _SO.exists():
                    raise
                log.debug("make failed (%s); loading existing %s", e, _SO.name)
            lib = ctypes.CDLL(str(_SO))
        except (OSError, subprocess.SubprocessError) as e:
            log.warning("native radix unavailable (%s); using Python tree", e)
            _load_failed = True
            return None
        lib.radix_new.restype = ctypes.c_void_p
        lib.radix_free.argtypes = [ctypes.c_void_p]
        lib.radix_apply_stored.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            _U64P, ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32,
        ]
        lib.radix_apply_removed.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, _U64P, ctypes.c_int32,
        ]
        lib.radix_remove_worker.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.radix_find_matches.restype = ctypes.c_int32
        lib.radix_find_matches.argtypes = [
            ctypes.c_void_p, _U64P, ctypes.c_int32, _I64P, _I32P, ctypes.c_int32,
        ]
        lib.radix_num_blocks.restype = ctypes.c_int32
        lib.radix_num_blocks.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.radix_dump_worker.restype = ctypes.c_int32
        lib.radix_dump_worker.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, _U64P, _U64P, _I32P, ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _hash_array(hashes) -> tuple[np.ndarray, _U64P]:
    arr = np.asarray(list(hashes), dtype=np.uint64)
    return arr, arr.ctypes.data_as(_U64P)


class NativeRadixTree:
    """Drop-in for the Python RadixTree, backed by the C++ index."""

    MAX_WORKERS = 4096

    def __init__(self) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native radix library unavailable")
        self._lib = lib
        self._ptr = ctypes.c_void_p(lib.radix_new())

    def __del__(self) -> None:
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.radix_free(ptr)
            self._ptr = None

    # -- mutation ----------------------------------------------------------

    def apply_event(self, event: RouterEvent) -> None:
        ev = event.event
        if ev.op == "stored":
            arr, p = _hash_array(ev.block_hashes)
            self._lib.radix_apply_stored(
                self._ptr, event.worker_id, event.event_id,
                p, len(arr),
                ctypes.c_uint64(ev.parent_hash or 0),
                1 if ev.parent_hash is not None else 0,
            )
        elif ev.op == "removed":
            arr, p = _hash_array(ev.block_hashes)
            self._lib.radix_apply_removed(
                self._ptr, event.worker_id, event.event_id, p, len(arr)
            )
        elif ev.op == "cleared":
            self.remove_worker(event.worker_id)

    def remove_worker(self, worker_id: int) -> None:
        self._lib.radix_remove_worker(self._ptr, worker_id)

    # -- queries -----------------------------------------------------------

    def find_matches(self, seq_hashes: list[int], early_exit: bool = False) -> dict[int, int]:
        if not seq_hashes:
            return {}
        arr, p = _hash_array(seq_hashes)
        workers = np.zeros(self.MAX_WORKERS, np.int64)
        depths = np.zeros(self.MAX_WORKERS, np.int32)
        n = self._lib.radix_find_matches(
            self._ptr, p, len(arr),
            workers.ctypes.data_as(_I64P), depths.ctypes.data_as(_I32P),
            self.MAX_WORKERS,
        )
        return {int(workers[i]): int(depths[i]) for i in range(n)}

    def num_blocks(self, worker_id: int | None = None) -> int:
        return int(self._lib.radix_num_blocks(self._ptr, -1 if worker_id is None else worker_id))

    def dump_as_events(self, worker_id: int) -> list[RouterEvent]:
        cap = max(self.num_blocks(worker_id), 1)
        hashes = np.zeros(cap, np.uint64)
        parents = np.zeros(cap, np.uint64)
        has_parent = np.zeros(cap, np.int32)
        n = self._lib.radix_dump_worker(
            self._ptr, worker_id,
            hashes.ctypes.data_as(_U64P), parents.ctypes.data_as(_U64P),
            has_parent.ctypes.data_as(_I32P), cap,
        )
        return [
            RouterEvent(
                worker_id, i + 1,
                KvCacheEvent(
                    op="stored",
                    block_hashes=(int(hashes[i]),),
                    parent_hash=int(parents[i]) if has_parent[i] else None,
                ),
            )
            for i in range(n)
        ]

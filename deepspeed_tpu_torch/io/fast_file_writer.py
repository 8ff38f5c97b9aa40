"""FastFileWriter: double-buffered bulk tensor serialization.

Port of ``deepspeed_tpu/io/fast_file_writer.py`` (the reference's
``deepspeed/io/fast_file_writer.py``, ``FastFileWriter`` :44, and its mock
and py writers): checkpoint bytes are staged into one of two host buffers
while the other is in flight to storage on a flush thread, so
serialization overlaps I/O.  The flight path is a plain buffered
``write``: the native AIO handle (``csrc/aio``, libaio) the JAX package
uses when it is built is not ported (ROADMAP Queue A item 7), so
``use_aio=True`` raises, and ``use_aio=None`` (the default, "when
available") takes the plain write.

File format (used by ``checkpoint/fast_engine.py``), byte for byte the JAX
package's, so a file written by either package reads in the other: an
8-byte little-endian header length, a JSON index ``{path: {dtype, shape,
offset, nbytes}}``, then the raw tensor bytes back to back.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.runtime.config import not_ported


class _Buffer:
    def __init__(self, nbytes: int):
        self.data = np.empty(nbytes, dtype=np.uint8)
        self.fill = 0

    def room(self) -> int:
        return self.data.size - self.fill

    def put(self, src: np.ndarray) -> int:
        n = min(self.room(), src.size)
        self.data[self.fill:self.fill + n] = src[:n]
        self.fill += n
        return n


class FastFileWriter:
    """Double-buffered writer. ``write(bytes_like)`` → staged; buffers
    flush when full; ``close()`` drains."""

    def __init__(self, path: str, buffer_bytes: int = 32 << 20,
                 use_aio: Optional[bool] = None):
        if use_aio:
            raise not_ported("FastFileWriter(use_aio=True) (the native AIO "
                             "handle, ops/aio and csrc/aio)", "Queue A item 7")
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "wb")
        self._bufs = [_Buffer(buffer_bytes), _Buffer(buffer_bytes)]
        self._cur = 0
        self._flusher: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.use_aio = False
        self._offset = 0
        self.bytes_written = 0
        self.flush_count = 0

    # ------------------------------------------------------------------
    def write(self, data) -> int:
        src = np.frombuffer(memoryview(data), dtype=np.uint8)
        written = 0
        while written < src.size:
            buf = self._bufs[self._cur]
            written += buf.put(src[written:])
            if buf.room() == 0:
                self._swap_and_flush()
        return written

    def write_array(self, arr: np.ndarray) -> int:
        return self.write(np.ascontiguousarray(arr).view(np.uint8).reshape(-1))

    # ------------------------------------------------------------------
    def _swap_and_flush(self) -> None:
        self._drain()  # previous in-flight buffer must land first
        buf = self._bufs[self._cur]
        self._cur ^= 1
        self._flusher = threading.Thread(target=self._flush_guarded,
                                         args=(buf,), daemon=True)
        self._flusher.start()

    def _flush_guarded(self, buf: _Buffer) -> None:
        try:
            self._flush_buf(buf)
        except BaseException as e:  # raised again by _drain
            self._error = e

    def _flush_buf(self, buf: _Buffer) -> None:
        chunk = buf.data[:buf.fill]
        self._fh.seek(self._offset)
        self._fh.write(memoryview(chunk))
        self._offset += buf.fill
        self.bytes_written += buf.fill
        self.flush_count += 1
        buf.fill = 0

    def _drain(self) -> None:
        if self._flusher is not None:
            self._flusher.join()
            self._flusher = None
        if self._error is not None:
            # a failed flush must fail the save, not vanish with its thread
            err, self._error = self._error, None
            self._fh.close()
            raise err

    def close(self) -> Dict[str, Any]:
        self._drain()
        buf = self._bufs[self._cur]
        if buf.fill:
            self._flush_buf(buf)
        self._fh.flush()
        self._fh.close()
        return {"bytes_written": self.bytes_written,
                "flush_count": self.flush_count}


class PyFileWriter:
    """Plain buffered writer with the same interface (ref py writer)."""

    def __init__(self, path: str, **_):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "wb")
        self.bytes_written = 0
        self.flush_count = 0

    def write(self, data) -> int:
        b = bytes(data)
        self._fh.write(b)
        self.bytes_written += len(b)
        return len(b)

    def write_array(self, arr: np.ndarray) -> int:
        return self.write(np.ascontiguousarray(arr).tobytes())

    def close(self) -> Dict[str, Any]:
        self._fh.close()
        return {"bytes_written": self.bytes_written, "flush_count": 0}


class MockFileWriter:
    """Counts bytes, writes nothing (ref deepspeed/io/mock_file_writer.py)."""

    def __init__(self, path: str, **_):
        self.path = path
        self.bytes_written = 0
        self.flush_count = 0

    def write(self, data) -> int:
        self.bytes_written += len(bytes(data))
        return self.bytes_written

    def write_array(self, arr: np.ndarray) -> int:
        self.bytes_written += arr.nbytes
        return arr.nbytes

    def close(self) -> Dict[str, Any]:
        return {"bytes_written": self.bytes_written, "flush_count": 0}


# ----------------------------------------------------------------------
# Indexed tensor-file format
# ----------------------------------------------------------------------

def write_tensor_file(path: str, tensors: Dict[str, np.ndarray],
                      writer_cls=FastFileWriter, **writer_kw) -> Dict[str, Any]:
    """Serialize {path: array} with a JSON index header."""
    index: Dict[str, Any] = {}
    offset = 0
    arrays = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        index[name] = {"dtype": arr.dtype.str, "shape": list(arr.shape),
                       "offset": offset, "nbytes": arr.nbytes}
        offset += arr.nbytes
        arrays.append(arr)
    header = json.dumps(index).encode()
    w = writer_cls(path, **writer_kw)
    w.write(struct.pack("<Q", len(header)))
    w.write(header)
    for arr in arrays:
        w.write_array(arr)
    return w.close()


def _read_into(f, meta: Dict[str, Any]) -> np.ndarray:
    """The entry at ``f``'s position, read straight into a fresh array
    (no intermediate bytes object)."""
    arr = np.empty(meta["shape"], dtype=np.dtype(meta["dtype"]))
    view = memoryview(arr.reshape(-1).view(np.uint8))
    got = f.readinto(view) if arr.nbytes else 0
    if got != meta["nbytes"]:
        raise EOFError(f"tensor entry truncated: read {got} of "
                       f"{meta['nbytes']} bytes")
    return arr


def read_tensor_index(path: str) -> Tuple[Dict[str, Any], int]:
    """→ (JSON index, data base offset) without reading any tensor bytes."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(hlen).decode()), 8 + hlen


def read_tensor_entry(path: str, base_offset: int,
                      meta: Dict[str, Any]) -> np.ndarray:
    """Read ONE entry given its index record (targeted seek, no parsing)."""
    with open(path, "rb") as f:
        f.seek(base_offset + meta["offset"])
        return _read_into(f, meta)


def read_tensor_file(path: str, names=None) -> Dict[str, np.ndarray]:
    """Read a tensor file; with ``names`` given, read only those entries
    (the index header + targeted seeks, not the whole file)."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        index = json.loads(f.read(hlen).decode())
        base = 8 + hlen
        out = {}
        for name, meta in index.items():
            if names is not None and name not in names:
                continue
            f.seek(base + meta["offset"])
            out[name] = _read_into(f, meta)
    return out

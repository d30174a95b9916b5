"""The row wire codec of the JAX package's ``tpu/dcn.py``.

The port keeps only the codec that ``flow/wal.py`` writes and reads:
``pack_rows``, ``pack_columns`` (the same bytes, built from columns) and
``unpack_rows``, copied unchanged, so the port's WAL segments are
byte-identical to the JAX package's. The socket source's ``format='rows'``
frames carry the same payload (``core/columns.py::unpack_columns`` decodes
it into columns). ``DCNWorker``, the lane topology and the rest of the
cross-host shard layer wait for ``ROADMAP.md`` §A8.
"""

from __future__ import annotations

import struct

import numpy as np

# column type chars (shared vocabulary with native/ingress.cpp's schema
# string): i=i32 l=i64 f=f32 d=f64 b=bool s=string
_NUM_DT = {"i": ">i4", "l": ">i8", "f": ">f4", "d": ">f8", "b": ">u1"}


def pack_rows(types: str, rows: list, timestamps: list) -> bytes:
    """Rows → self-describing SoA payload.

    Layout: ``u32 n · u8 n_cols · n_cols type chars · i64 ts[n]`` then per
    column ``u8 nulls[n]`` + (numeric: dense big-endian array | string:
    ``u32 offs[n+1]`` + utf-8 blob). Same SoA shape as the C++ lane
    buffers; byte order fixed big-endian for cross-host portability."""
    n = len(rows)
    parts = [struct.pack(">IB", n, len(types)), types.encode("ascii")]
    parts.append(np.asarray(timestamps, dtype=">i8").tobytes())
    cols = list(zip(*rows)) if n else [() for _ in types]
    for t, col in zip(types, cols):
        nulls = np.fromiter((v is None for v in col), np.uint8, count=n)
        parts.append(nulls.tobytes())
        if t == "s":
            blobs = [b"" if v is None else str(v).encode() for v in col]
            offs = np.zeros(n + 1, dtype=">u4")
            if n:
                np.cumsum([len(b) for b in blobs], out=offs[1:])
            parts.append(offs.tobytes())
            parts.append(b"".join(blobs))
        else:
            arr = np.array([0 if v is None else v for v in col],
                           dtype=_NUM_DT[t])
            parts.append(arr.tobytes())
    return b"".join(parts)


def pack_columns(types: str, cols: list, timestamps) -> bytes:
    """Columns → the SAME self-describing SoA payload as :func:`pack_rows`,
    built WITHOUT materializing per-event row lists (the bulk forwarding
    path: a :class:`~siddhi_tpu_torch.core.columns.RowsChunk` ships straight from
    its numpy columns into wire bytes — byte-identical layout, pinned by
    tests against ``pack_rows`` on the same data). ``cols`` is positional
    (one entry per type char): numeric columns as numpy arrays (object
    arrays may carry None → null bit + zero), string columns as object
    arrays/lists of ``str | None``."""
    ts = np.asarray(timestamps, dtype=np.int64)
    n = int(ts.shape[0])
    parts = [struct.pack(">IB", n, len(types)), types.encode("ascii"),
             ts.astype(">i8").tobytes()]
    for t, col in zip(types, cols):
        if t == "s":
            vals = col if isinstance(col, np.ndarray) \
                else np.asarray(col, dtype=object)
            nulls = np.fromiter((v is None for v in vals), np.uint8,
                                count=n)
            parts.append(nulls.tobytes())
            blobs = [b"" if v is None else str(v).encode() for v in vals]
            offs = np.zeros(n + 1, dtype=">u4")
            if n:
                np.cumsum([len(b) for b in blobs], out=offs[1:])
            parts.append(offs.tobytes())
            parts.append(b"".join(blobs))
        else:
            arr = np.asarray(col)
            if arr.dtype == object:
                nulls = np.fromiter((v is None for v in arr), np.uint8,
                                    count=n)
                arr = np.array([0 if v is None else v for v in arr],
                               dtype=_NUM_DT[t])
            else:
                nulls = np.zeros(n, dtype=np.uint8)
                arr = arr.astype(_NUM_DT[t], copy=False)
            parts.append(nulls.tobytes())
            parts.append(arr.tobytes())
    return b"".join(parts)


def unpack_rows(payload: bytes) -> tuple[list, list]:
    """Inverse of :func:`pack_rows`; returns (rows, timestamps)."""
    n, n_cols = struct.unpack_from(">IB", payload, 0)
    pos = 5
    types = payload[pos: pos + n_cols].decode("ascii")
    pos += n_cols
    ts = np.frombuffer(payload, dtype=">i8", count=n, offset=pos)
    pos += 8 * n
    cols = []
    for t in types:
        nulls = np.frombuffer(payload, dtype=np.uint8, count=n, offset=pos)
        pos += n
        if t == "s":
            offs = np.frombuffer(payload, dtype=">u4", count=n + 1,
                                 offset=pos)
            pos += 4 * (n + 1)
            blob = payload[pos: pos + int(offs[-1])]
            pos += int(offs[-1])
            col = [None if nulls[i] else
                   blob[int(offs[i]): int(offs[i + 1])].decode()
                   for i in range(n)]
        else:
            arr = np.frombuffer(payload, dtype=_NUM_DT[t], count=n,
                                offset=pos)
            pos += arr.itemsize * n
            if t == "b":
                col = [None if nulls[i] else bool(arr[i]) for i in range(n)]
            elif t in ("i", "l"):
                col = [None if nulls[i] else int(arr[i]) for i in range(n)]
            else:
                col = [None if nulls[i] else float(arr[i]) for i in range(n)]
        cols.append(col)
    rows = [[c[i] for c in cols] for i in range(n)]
    return rows, [int(x) for x in ts]



"""Native (C++) CSV ingress, loaded with ctypes.

``ingress.cpp`` parses raw CSV lines, dictionary-encodes strings, routes rows
to partition lanes (crc32, bit-identical to ``gpu/partition.py::_hash_key``)
and packs fixed-capacity SoA column buffers that ``emit_lane`` copies into
numpy arrays, ready for the step's pinned host-to-device copy.

The library is built with ``g++ -O3`` at first use into ``_build/``
(git-ignored), under a name that carries a hash of the source and the flags,
so an edited source rebuilds and a built one is reused. It is built to a
temporary name and moved into place, so processes that build at once never
load a half-written file. ``native_available()`` says whether a toolchain
exists; where one does, a build or a load that fails raises with the
compiler's output instead of passing for "unavailable".
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ingress.cpp")
_BUILD_DIR = os.path.join(_HERE, "_build")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lib_lock = threading.Lock()


def _compiler() -> str | None:
    return shutil.which(os.environ.get("CXX", "g++"))


def _target() -> str:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(_BUILD_DIR,
                        f"libsiddhi_ingress-{digest.hexdigest()[:16]}.so")


def _build(cxx: str, out: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        got = subprocess.run([cxx, *_FLAGS, "-o", tmp, _SRC],
                             capture_output=True, text=True, timeout=300)
        if got.returncode != 0:
            raise RuntimeError(f"native ingress: {cxx} failed:\n"
                               f"{got.stdout}{got.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL:
    """The built library (built on first call); raises RuntimeError without
    a toolchain or when the build fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        cxx = _compiler()
        if cxx is None:
            raise RuntimeError("native ingress unavailable (no g++)")
        out = _target()
        if not os.path.exists(out):
            _build(cxx, out)
        lib = ctypes.CDLL(out)
        lib.sp_create.restype = ctypes.c_void_p
        lib.sp_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int64]
        lib.sp_destroy.argtypes = [ctypes.c_void_p]
        lib.sp_encode.restype = ctypes.c_int32
        lib.sp_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int64]
        lib.sp_dict_size.restype = ctypes.c_int64
        lib.sp_dict_size.argtypes = [ctypes.c_void_p]
        lib.sp_dict_get.restype = ctypes.c_int64
        lib.sp_dict_get.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                    ctypes.c_char_p, ctypes.c_int64]
        lib.sp_lane_of.restype = ctypes.c_int32
        lib.sp_lane_of.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int64]
        lib.sp_lane_len.restype = ctypes.c_int64
        lib.sp_lane_len.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.sp_parse_errors.restype = ctypes.c_int64
        lib.sp_parse_errors.argtypes = [ctypes.c_void_p]
        lib.sp_ingest_csv.restype = ctypes.c_int64
        lib.sp_ingest_csv.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int32, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64)]
        for fn in (lib.sp_emit_lane, lib.sp_emit_lane_wide):
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                           ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        return lib


# 'd' emits as float32: parse keeps full double precision in the staging
# cells, but emit narrows to the device policy float (gpu/dtypes.py). The
# wide emit (emit_lane(wide=True)) keeps 'd' as float64 for the columnar
# edge, where the policy is f64.
_TYPE_NP = {
    "f": np.float32, "d": np.float32, "i": np.int32, "l": np.int64,
    "b": np.uint8, "s": np.int32,
}
_TYPE_NP_WIDE = dict(_TYPE_NP, d=np.float64)


class NativeIngress:
    """Lane-routed CSV ingress backed by the C++ library.

    ``types`` is one char per payload column ('f','d','i','l','b','s');
    ``key_col`` is the payload column index used for crc32 lane routing
    (-1 routes everything to lane 0).
    """

    def __init__(self, types: str, key_col: int = -1, n_lanes: int = 1,
                 capacity: int = 1024):
        lib = _load()
        self._lib = lib
        self.types = types
        self.n_lanes = n_lanes
        self.capacity = capacity
        self._h = lib.sp_create(types.encode(), len(types), key_col, n_lanes,
                                capacity)
        if not self._h:
            raise ValueError("sp_create failed (bad schema)")
        self._row_seq = ctypes.c_int64(0)
        self._decode_cache: list = [None]

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.sp_destroy(h)
            self._h = None

    # -- ingest ------------------------------------------------------------
    def ingest_csv(self, data: bytes, base_ts: int = 0, ts_last: bool = False,
                   tag: int = 0, final: bool = True, offset: int = 0) -> int:
        """Feeds raw CSV bytes starting at ``offset`` (no copy); returns bytes
        consumed (stops short when a lane filled up: drain with emit_lane and
        call again with offset advanced past the consumed prefix)."""
        addr = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value
        return self._lib.sp_ingest_csv(
            self._h, addr + offset, len(data) - offset, base_ts,
            1 if ts_last else 0, tag, 1 if final else 0,
            ctypes.byref(self._row_seq))

    # -- dictionary --------------------------------------------------------
    def encode(self, s: str) -> int:
        b = s.encode()
        return self._lib.sp_encode(self._h, b, len(b))

    def decode(self, code: int):
        if code == 0:
            return None
        cache = self._decode_cache
        if 0 < code < len(cache) and cache[code] is not None:
            return cache[code]
        if code < 0 or code >= self._lib.sp_dict_size(self._h):
            return None
        cap = 4096
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.sp_dict_get(self._h, code, buf, cap)
            if n >= 0:
                break
            cap *= 2  # valid code, so -1 means the buffer was too small
        s = buf.raw[:n].decode()
        while len(cache) <= code:
            cache.append(None)
        cache[code] = s
        return s

    def dict_size(self) -> int:
        return self._lib.sp_dict_size(self._h)

    def lane_of(self, key: str) -> int:
        b = key.encode()
        return self._lib.sp_lane_of(self._h, b, len(b))

    def lane_len(self, lane: int) -> int:
        return self._lib.sp_lane_len(self._h, lane)

    @property
    def parse_errors(self) -> int:
        return self._lib.sp_parse_errors(self._h)

    # -- emit --------------------------------------------------------------
    def emit_lane(self, lane: int, wide: bool = False) -> dict:
        """Drains one lane into fresh numpy arrays padded to capacity.

        Returns {'cols': [np array per payload column], 'ts', 'tag', 'valid',
        'count'}, the batch builders' contract. ``wide=True`` keeps 'd'
        columns as float64 (``sp_emit_lane_wide``)."""
        cap = self.capacity
        fn = self._lib.sp_emit_lane_wide if wide else self._lib.sp_emit_lane
        dts = _TYPE_NP_WIDE if wide else _TYPE_NP
        cols = [np.zeros(cap, dtype=dts[t]) for t in self.types]
        ts = np.zeros(cap, dtype=np.int64)
        tag = np.zeros(cap, dtype=np.int32)
        valid = np.zeros(cap, dtype=np.uint8)
        ptrs = (ctypes.c_void_p * len(cols))(
            *[c.ctypes.data_as(ctypes.c_void_p).value for c in cols])
        n = fn(
            self._h, lane, ptrs,
            ts.ctypes.data_as(ctypes.c_void_p),
            tag.ctypes.data_as(ctypes.c_void_p),
            valid.ctypes.data_as(ctypes.c_void_p))
        return {"cols": cols, "ts": ts, "tag": tag,
                "valid": valid.astype(bool), "count": int(n)}


def native_available() -> bool:
    """True where a C++ toolchain exists (the library builds at first use;
    a build that fails there raises)."""
    return _compiler() is not None

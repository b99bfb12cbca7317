"""Zstandard streams over the system's libzstd (``libzstd.so.1``), bound
with ctypes through its streaming API: ZSTD_decompressStream to read,
ZSTD_compressStream2 to write. The port needs no ``zstandard`` module.

``Reader(raw, name)`` is a readable raw stream of the decompressed bytes
of every frame in ``raw``; ``Writer(raw, level, name)`` a writable one
whose ``close()`` ends the frame (the file itself stays open). ``name``
is the file the stream belongs to, for error messages.
"""

from __future__ import annotations

import ctypes
import io
from typing import BinaryIO

LIBRARY = "libzstd.so.1"
_C_COMPRESSION_LEVEL = 100   # ZSTD_c_compressionLevel
_E_CONTINUE, _E_FLUSH, _E_END = 0, 1, 2  # ZSTD_EndDirective

_lib: ctypes.CDLL | None = None


class ZstdError(OSError):
    pass


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def library(name: str) -> ctypes.CDLL:
    """The bound libzstd; raises ZstdError naming the library and ``name``
    (the file that needs it) when it cannot be loaded."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(LIBRARY)
    except OSError as e:
        raise ZstdError(
            f"{name}: zstd streams need the system library {LIBRARY}, "
            f"which could not be loaded ({e})"
        ) from None
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    ib, ob = ctypes.POINTER(_InBuffer), ctypes.POINTER(_OutBuffer)
    for fn, res, args in (
        ("ZSTD_createDCtx", vp, []),
        ("ZSTD_freeDCtx", sz, [vp]),
        ("ZSTD_decompressStream", sz, [vp, ob, ib]),
        ("ZSTD_DStreamInSize", sz, []),
        ("ZSTD_createCCtx", vp, []),
        ("ZSTD_freeCCtx", sz, [vp]),
        ("ZSTD_CCtx_setParameter", sz, [vp, ctypes.c_int, ctypes.c_int]),
        ("ZSTD_compressStream2", sz, [vp, ob, ib, ctypes.c_int]),
        ("ZSTD_CStreamOutSize", sz, []),
        ("ZSTD_isError", ctypes.c_uint, [sz]),
        ("ZSTD_getErrorName", ctypes.c_char_p, [sz]),
    ):
        f = getattr(lib, fn)
        f.restype, f.argtypes = res, args
    _lib = lib
    return lib


def _check(lib: ctypes.CDLL, ret: int, what: str, name: str) -> int:
    if lib.ZSTD_isError(ret):
        raise ZstdError(
            f"{name}: {what}: {lib.ZSTD_getErrorName(ret).decode()}")
    return ret


class Reader(io.RawIOBase):
    def __init__(self, raw: BinaryIO, name: str):
        self._dctx = None  # close() runs even when __init__ raises
        self._lib = library(name)
        self._name = name
        self._raw = raw
        self._dctx = self._lib.ZSTD_createDCtx()
        if not self._dctx:
            raise ZstdError(f"{name}: ZSTD_createDCtx failed")
        self._chunk = int(self._lib.ZSTD_DStreamInSize())
        self._src = b""  # keeps the input buffer's bytes alive
        self._in = _InBuffer(None, 0, 0)
        self._pending = False  # output may remain inside the context
        self._last = 0  # 0 once a frame is fully decoded and flushed

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        n = len(b)
        if n == 0:
            return 0
        dst = (ctypes.c_char * n).from_buffer(b)
        out = _OutBuffer(ctypes.addressof(dst), n, 0)
        while True:
            if self._in.pos == self._in.size and not self._pending:
                self._src = self._raw.read(self._chunk)
                if not self._src:
                    if self._last != 0:
                        raise ZstdError(
                            f"{self._name}: truncated zstd frame")
                    return 0
                self._in = _InBuffer(
                    ctypes.cast(ctypes.c_char_p(self._src), ctypes.c_void_p),
                    len(self._src), 0)
            self._last = _check(self._lib, self._lib.ZSTD_decompressStream(
                self._dctx, ctypes.byref(out), ctypes.byref(self._in)),
                "ZSTD_decompressStream", self._name)
            self._pending = out.pos == out.size
            if out.pos:
                return int(out.pos)

    def close(self) -> None:
        if self._dctx:
            self._lib.ZSTD_freeDCtx(self._dctx)
            self._dctx = None
        super().close()


class Writer(io.RawIOBase):
    def __init__(self, raw: BinaryIO, level: int, name: str):
        self._cctx = None  # close() runs even when __init__ raises
        self._lib = library(name)
        self._name = name
        self._raw = raw
        self._cctx = self._lib.ZSTD_createCCtx()
        if not self._cctx:
            raise ZstdError(f"{name}: ZSTD_createCCtx failed")
        _check(self._lib, self._lib.ZSTD_CCtx_setParameter(
            self._cctx, _C_COMPRESSION_LEVEL, int(level)),
            "ZSTD_c_compressionLevel", name)
        self._out = ctypes.create_string_buffer(
            int(self._lib.ZSTD_CStreamOutSize()))

    def writable(self) -> bool:
        return True

    def _stream(self, data: bytes, directive: int) -> None:
        """Feed data with one end directive until the library has taken all
        of it and, for flush and end, has nothing left to write."""
        src = bytes(data)
        inb = _InBuffer(ctypes.cast(ctypes.c_char_p(src), ctypes.c_void_p),
                        len(src), 0)
        while True:
            out = _OutBuffer(ctypes.addressof(self._out), len(self._out), 0)
            left = _check(self._lib, self._lib.ZSTD_compressStream2(
                self._cctx, ctypes.byref(out), ctypes.byref(inb), directive),
                "ZSTD_compressStream2", self._name)
            if out.pos:
                self._raw.write(ctypes.string_at(self._out, out.pos))
            done = inb.pos == inb.size
            if done and (directive == _E_CONTINUE or left == 0):
                return

    def write(self, data) -> int:
        n = len(data)
        if n:
            self._stream(data, _E_CONTINUE)
        return n

    def flush(self) -> None:
        if self._cctx:
            self._stream(b"", _E_FLUSH)
            self._raw.flush()

    def close(self) -> None:
        """End the frame and free the context; the file stays open."""
        if self._cctx:
            self._stream(b"", _E_END)
            self._raw.flush()
            self._lib.ZSTD_freeCCtx(self._cctx)
            self._cctx = None
        super().close()


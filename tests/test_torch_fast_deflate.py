"""The port's one-shot raw-deflate compressor (fastdef, the host engine's
gzip and BGZF members; dx_deflate_raw): the counterparts of
tests/test_fast_deflate.py. Everything it emits inflates exactly with
zlib and with the port's own inflater, and equals the JAX package's
compressor's bytes on the same input."""

import ctypes
import zlib

import numpy as np
import pytest

from deacon_tpu.io.native_loader import get_lib as jax_lib
from deacon_tpu_torch.io.native_loader import library


def _compress(data: bytes, lib=None) -> bytes:
    lib = library() if lib is None else lib
    cap = len(data) + len(data) // 8 + 4096
    out = np.zeros(cap, np.uint8)
    inp = np.frombuffer(data if data else b"\x00", np.uint8)
    n = lib.dx_deflate_raw(inp.ctypes.data, len(data), out.ctypes.data, cap)
    assert n > 0
    return out[:n].tobytes()


def _jax_compress(data: bytes) -> bytes:
    lib = jax_lib()
    lib.dx_deflate_raw.restype = ctypes.c_int64
    lib.dx_deflate_raw.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p, ctypes.c_int64]
    return _compress(data, lib)


RNG = np.random.default_rng(1)
BASES = np.frombuffer(b"ACGT", np.uint8)
_q = bytes(RNG.integers(33, 74, 300, dtype=np.uint8))
CASES = {
    "empty": b"",
    "one": b"A",
    "short": b"hello",
    "rle": b"A" * 100_000,
    "random": bytes(RNG.integers(0, 256, 1 << 18, dtype=np.uint8)),
    "dna": RNG.choice(BASES, 1 << 18).tobytes(),
    "period8": b"ATCGATCG" * 8192,
    "period5": b"ABCDE" * 20000,
    "fastq": b"".join(
        b"@r%d\n%s\n+\n%s\n" % (i, RNG.choice(BASES, 300).tobytes(), _q)
        for i in range(500)
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_zlib_inflates_our_deflate(name):
    data = CASES[name]
    ours = _compress(data)
    assert zlib.decompress(ours, -15) == data
    assert ours == _jax_compress(data)


def test_own_inflater_roundtrip():
    data = CASES["fastq"]
    comp = _compress(data)
    out = np.zeros(len(data) + 32, np.uint8)
    inp = np.frombuffer(comp, np.uint8)
    rc = library().dx_inflate_raw(inp.ctypes.data, len(comp),
                                  out.ctypes.data, len(data))
    assert rc == 0 and out[:len(data)].tobytes() == data


def test_ratio_not_worse_than_zlib_fast():
    # one dynamic Huffman block per member beats zlib level 1 on FASTQ
    data = CASES["fastq"]
    assert len(_compress(data)) < len(zlib.compress(data, 1))
    # incompressible data falls back to stored blocks (~n + headers)
    rnd = CASES["random"]
    assert len(_compress(rnd)) <= len(rnd) + 5 * (len(rnd) // 65535 + 2)


def test_random_fuzz_roundtrip():
    rng = np.random.default_rng(777)
    for it in range(300):
        n = int(rng.integers(0, 200_000))
        kind = rng.integers(0, 5)
        if kind == 0:
            data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        elif kind == 1:
            data = RNG.choice(BASES, n).tobytes()
        elif kind == 2:
            pat = bytes(rng.integers(0, 256, int(rng.integers(1, 40)),
                                     dtype=np.uint8))
            data = (pat * (n // max(1, len(pat)) + 1))[:n]
        elif kind == 3:
            data = bytes([int(rng.integers(0, 256))]) * n
        else:
            half = n // 2
            data = RNG.choice(BASES, half).tobytes() + bytes(
                rng.integers(33, 74, n - half, dtype=np.uint8))
        assert zlib.decompress(_compress(data), -15) == data, (it, n, kind)

"""The port's CUDA kernels: wrappers, plain PyTorch versions, counters.

* K1 ``select_compact`` (csrc/extract.cu) replaces the TPU kernel
  ``select_compact_packed`` (deacon_tpu/ops/pallas_kernels.py): O(1)
  work per base on the card (k-mers sliced from the packed words, a
  van Herk / Gil-Werman window minimum, one scan per row;
  csrc/select_rows.cuh).
* K2 ``probe_hits`` (csrc/radix_probe.cu) replaces the TPU kernel
  ``radix_probe_hits`` (deacon_tpu/ops/radix_probe.py), whole-table and
  sharded (a block of bucket rows, ``row_lo``).
* K3 ``values_select`` (csrc/values_select.cu) replaces the TPU kernel
  ``values_select_fused`` (deacon_tpu/ops/pallas_kernels.py) and the
  compaction after it: K1's design and slot grid for k <= 57, with
  128-bit values (csrc/select_rows.cuh, shared with K1).
* K4 ``select_csum`` (csrc/select_csum.cu) replaces the TPU kernel
  ``select_csum_packed`` (deacon_tpu/ops/pallas_kernels.py) and the
  slot search after it: K1's function and instantiation, writing the
  slot grid.
* K5 ``values_argmin`` (csrc/values_argmin.cu) replaces the TPU kernel
  ``values_argmin_fused`` (deacon_tpu/ops/pallas_kernels.py) and the flag
  mask, gather and compaction after it: K3's function and
  instantiations for k <= 56, writing the slot grid.

K1, K3, K4 and K5 share their device code (csrc/select_rows.cuh). Each
keeps a dense plain version of its TPU kernel (values_select_plain,
select_csum_plain, values_argmin_plain) beside the plain version of the
kernel itself, for the tests against the JAX package.

A wrapper runs its plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel on the current stream of the tensors'
device, made the current device for the launch (no synchronisation), or
raises; it never falls back. Each wrapper counts its kernel launches in
its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from .hash import lsr

_M32 = 0xFFFFFFFF
_I64_MIN = -(1 << 63)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous on {device}")


def _check_tile(name: str, pc, pv, mlen, allow_short, k: int, w: int,
                Br: int, kmax: int):
    """The inputs of a selection kernel writing the slot grid (K1, K3-K5):
    1 <= k <= kmax, 128 | L <= 16384, 128 | Br <= L. Returns (R, L,
    device)."""
    R, Lp = pc.shape
    L = Lp * 4
    if not (1 <= k <= kmax and w >= 1):
        raise ValueError(f"{name} supports 1 <= k <= {kmax}, got k={k}")
    if L % 128 or not 0 < L <= 16384:
        raise ValueError(f"{name}: bad tile L={L} (need 128 | L <= 16384)")
    if Br % 128 or not 0 < Br <= L:
        raise ValueError(f"{name}: bad tile L={L}, Br={Br}")
    dev = pc.device
    _require(pc, "packed codes", torch.uint8, (R, L // 4), dev)
    _require(pv, "packed validity", torch.uint8, (R, L // 8), dev)
    _require(mlen, "mlen", torch.int32, (R,), dev)
    _require(allow_short, "allow_short", torch.bool, (R,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return R, L, dev


# ---------------------------------------------------------------------------
# K1: extraction + per-row compaction
# ---------------------------------------------------------------------------

def _shift_cols(x: torch.Tensor, n: int, fill: int) -> torch.Tensor:
    """x[:, c] <- x[:, c + n], the last n columns set to ``fill``."""
    if n == 0:
        return x
    pad = torch.full((x.shape[0], n), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[:, n:], pad], dim=1)


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 tensors holding u32 values."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def _next_pow2(k: int) -> int:
    s = 1
    while s < k:
        s *= 2
    return s


def _shl128(lo, hi, n: int):
    """(lo, hi) u128 bit patterns << n (static 0 < n <= 64)."""
    if n == 64:
        return torch.zeros_like(lo), lo
    return lo << n, (hi << n) | lsr(lo, 64 - n)


def _shr128(lo, hi, n: int):
    """(lo, hi) u128 bit patterns >> n, logical (static 0 < n < 64)."""
    return lsr(lo, n) | (hi << (64 - n)), lsr(hi, n)


def _canonical_plain(codes: torch.Tensor, k: int):
    """Canonical k-mer value min(fwd, revcomp) at every column of (R, L)
    int64 codes, by span doubling to S = next_pow2(k) and a trim (bases
    past L count as 0 on both strands). Returns [lo] for k <= 32, else
    [lo, hi] (u64 halves of the u128 value, as int64)."""
    S = _next_pow2(k)
    if k <= 32:
        f, r = codes, codes ^ 2
        s = 1
        while s < S:
            f = f | (_shift_cols(f, s, 0) << (2 * s))
            r = (r << (2 * s)) | _shift_cols(r, s, 0)
            s *= 2
        if S != k:
            f = f & ((1 << (2 * k)) - 1)
            r = lsr(r, 2 * (S - k))
        take_f = (f ^ _I64_MIN) <= (r ^ _I64_MIN)  # unsigned f <= r
        return [torch.where(take_f, f, r)]
    zero = torch.zeros_like(codes)
    f, r = (codes, zero), (codes ^ 2, zero)
    s = 1
    while s < S:
        g = _shl128(_shift_cols(f[0], s, 0), _shift_cols(f[1], s, 0), 2 * s)
        f = (f[0] | g[0], f[1] | g[1])
        g = _shl128(r[0], r[1], 2 * s)
        r = (g[0] | _shift_cols(r[0], s, 0), g[1] | _shift_cols(r[1], s, 0))
        s *= 2
    f = (f[0], f[1] & ((1 << (2 * k - 64)) - 1))
    r = _shr128(r[0], r[1], 2 * (S - k))
    fh, rh = f[1] ^ _I64_MIN, r[1] ^ _I64_MIN
    take_f = (fh < rh) | ((fh == rh) & ((f[0] ^ _I64_MIN) <= (r[0] ^ _I64_MIN)))
    return [torch.where(take_f, f[0], r[0]), torch.where(take_f, f[1], r[1])]


def _unpack_codes(pc: torch.Tensor) -> torch.Tensor:
    """(R, L/4) uint8 packed codes -> (R, L) int64 2-bit codes."""
    R, Lp = pc.shape
    pc64 = pc.to(torch.int64)
    return torch.stack(
        [(pc64 >> (2 * j)) & 3 for j in range(4)], dim=2
    ).reshape(R, 4 * Lp)


def _values_wp(pc, mlen, *, k: int, w: int):
    """Canonical value planes at every column ([lo] or [lo, hi], see
    _canonical_plain) and the (R, L) int64 leftmost window minimum wp of
    the selection keys (fmix32 of the value's folded 32-bit limbs, the
    column in the low 16 bits; the largest priority past mlen)."""
    R, Lp = pc.shape
    L = Lp * 4
    canon = _canonical_plain(_unpack_codes(pc), k)
    fold = torch.zeros_like(canon[0])
    for v in canon:
        fold = fold ^ (v & _M32) ^ lsr(v, 32)
    col = torch.arange(L, dtype=torch.int64, device=pc.device)[None, :]
    in_row = col < mlen.to(torch.int64)[:, None]
    prio = _fmix32(fold) & 0xFFFF0000
    t = torch.where(in_row, prio, 0xFFFF0000) | col
    # leftmost window minimum by doubling (keys are distinct)
    span = 1
    while span * 2 <= w:
        t = torch.minimum(t, _shift_cols(t, span, _M32))
        span *= 2
    if w - span > 0:
        t = torch.minimum(t, _shift_cols(t, w - span, _M32))
    return canon, torch.clamp(t & 0xFFFF, max=L - 1)


def flag_mask(wp, pv, mlen, allow_short, *, k: int, w: int) -> torch.Tensor:
    """(R, L) bool final candidate flag of every window, from its argmin
    wp ((R, L) integer) and the row's validity bits pv (R, L/8) uint8:
    window valid (c <= mlen - w, or c == 0 for a short read with
    allow_short and mlen >= 1), a new minimum (c == 0 or wp changes) and
    an ACGT-valid k-mer at wp, inside the row. The counterpart of the JAX
    package's _stage_flag_mask."""
    R, L = wp.shape
    dev = wp.device
    wp = wp.to(torch.int64)
    pv64 = pv.to(torch.int64)
    valid = torch.stack(
        [(pv64 >> j) & 1 for j in range(8)], dim=2
    ).reshape(R, L)
    col = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    m = mlen.to(torch.int64)[:, None]
    # k-mer validity: no invalid base in [c, c+k), the row's end included
    inv = torch.cat([
        torch.zeros((R, 1), dtype=torch.int64, device=dev),
        1 - valid,
        torch.ones((R, k), dtype=torch.int64, device=dev),
    ], dim=1).cumsum(dim=1)
    kv = ((inv[:, k:k + L] - inv[:, :L]) == 0) & (col < m)
    prev = torch.cat([
        torch.full((R, 1), -1, dtype=torch.int64, device=dev), wp[:, :-1]
    ], dim=1)
    new_min = (col == 0) | (wp != prev)
    win_valid = (col <= m - w) | (
        (col == 0) & allow_short.to(torch.bool)[:, None] & (m >= 1)
    )
    return win_valid & new_min & kv.gather(1, wp)


def _select_plain(pc, pv, mlen, allow_short, *, k: int, w: int):
    """The selection every extraction kernel computes, in plain PyTorch:
    (canonical value planes at every column ([lo] or [lo, hi], see
    _canonical_plain), (R, L) int64 leftmost window minimum wp, (R, L)
    bool final candidate flag)."""
    canon, wp = _values_wp(pc, mlen, k=k, w=w)
    return canon, wp, flag_mask(wp, pv, mlen, allow_short, k=k, w=w)


def compact_rows(flag: torch.Tensor, wp: torch.Tensor,
                 planes: list[torch.Tensor], Br: int):
    """Order-preserving per-row compaction of flagged windows into an
    (R, Br) slot grid: slot j of row r gets the j-th flagged column's wp
    and plane values. Returns ((R, Br) int32 positions, [(R, Br) planes],
    (R,) int32 row totals, which count past Br). Slots at or past a row's
    total hold zeros. One scatter per plane with no host synchronisation:
    windows not kept go to a dump slot past the grid."""
    R, L = flag.shape
    dev = flag.device
    cs = flag.to(torch.int32).cumsum(dim=1)
    keep = flag & (cs <= Br)
    dest = torch.where(
        keep,
        torch.arange(R, dtype=torch.int64, device=dev)[:, None] * Br
        + cs.to(torch.int64) - 1,
        R * Br,
    ).reshape(-1)

    def scatter(x, dtype):
        out = torch.zeros(R * Br + 1, dtype=dtype, device=dev)
        out.scatter_(0, dest, x.reshape(-1).to(dtype))
        return out[:-1].reshape(R, Br)

    return (scatter(wp, torch.int32),
            [scatter(x, torch.int64) for x in planes],
            cs[:, -1].contiguous())


def select_compact_plain(pc, pv, mlen, allow_short, *, k: int, w: int,
                         Br: int):
    """Plain PyTorch version of K1 (the same function as the kernel).

    pc (R, L/4) uint8 packed codes, pv (R, L/8) uint8 validity bits,
    mlen (R,) int32 k-mer counts (-1 for an unused row), allow_short (R,)
    bool. Returns ((R, Br) int32 minimizer positions, (R, Br) int64
    canonical values, (R,) int32 row totals); slots at or past a row's
    total hold zeros here and are unspecified in general."""
    (canon,), wp, flag = _select_plain(pc, pv, mlen, allow_short, k=k, w=w)
    pos, (val,), tot = compact_rows(flag, wp, [canon.gather(1, wp)], Br)
    return pos, val, tot


def select_compact(pc, pv, mlen, allow_short, *, k: int, w: int, Br: int):
    """K1 wrapper: same arguments and results as select_compact_plain.
    Constraints (the TPU kernel's): k <= 32, 128 | L <= 16384,
    128 | Br <= L."""
    R, L, dev = _check_tile("select_compact", pc, pv, mlen, allow_short, k,
                            w, Br, 32)
    if dev.type == "cpu":
        return select_compact_plain(pc, pv, mlen, allow_short, k=k, w=w, Br=Br)
    from . import _build

    lib = _build.library()
    pos = torch.empty((R, Br), dtype=torch.int32, device=dev)
    val = torch.empty((R, Br), dtype=torch.int64, device=dev)
    tot = torch.empty((R,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.dx_select_compact(
            _ptr(pc), _ptr(pv), _ptr(mlen), _ptr(allow_short), _ptr(pos),
            _ptr(val), _ptr(tot), R, L, k, w, Br, _stream(dev),
        )
    _build.check(err, "select_compact launch")
    select_compact.launches += 1
    return pos, val, tot


select_compact.launches = 0


# ---------------------------------------------------------------------------
# K3: wide-k selection into the slot grid
# ---------------------------------------------------------------------------

def values_select_plain(pc, pv, mlen, allow_short, *, k: int, w: int):
    """The JAX package's values_select_fused in plain PyTorch, dense.

    Inputs as select_compact_plain. Returns three dense (R, L) planes: the
    low and high 64 bits (int64) of the canonical value of the k-mer
    selected for the window starting at each column (the value at wp; the
    high half is zero when k <= 32), and int32 ``wpf`` = wp | flag << 16
    (flag: window valid, a new minimum, and a valid k-mer at wp)."""
    canon, wp, flag = _select_plain(pc, pv, mlen, allow_short, k=k, w=w)
    lo = canon[0].gather(1, wp)
    hi = canon[1].gather(1, wp) if k > 32 else torch.zeros_like(lo)
    wpf = (wp | (flag.to(torch.int64) << 16)).to(torch.int32)
    return lo, hi, wpf


def values_select_compact_plain(pc, pv, mlen, allow_short, *, k: int,
                                w: int, Br: int):
    """Plain PyTorch version of K3 (the same function as the kernel):
    values_select_plain's flagged windows compacted into the slot grid
    (compact_rows). Returns ((R, Br) int32 positions, (R, Br) int64 low
    halves, (R, Br) int64 high halves or None for k <= 32, (R,) int32 row
    totals); slots at or past a row's total hold zeros here and are
    unspecified in general."""
    lo, hi, wpf = values_select_plain(pc, pv, mlen, allow_short, k=k, w=w)
    pos, planes, tot = compact_rows((wpf >> 16) != 0, wpf & 0xFFFF,
                                    [lo, hi] if k > 32 else [lo], Br)
    return pos, planes[0], planes[1] if k > 32 else None, tot


def values_select(pc, pv, mlen, allow_short, *, k: int, w: int, Br: int):
    """K3 wrapper: same arguments and results as
    values_select_compact_plain. Constraints: 1 <= k <= 57,
    128 | L <= 16384, 128 | Br <= L."""
    R, L, dev = _check_tile("values_select", pc, pv, mlen, allow_short, k,
                            w, Br, 57)
    if dev.type == "cpu":
        return values_select_compact_plain(pc, pv, mlen, allow_short, k=k,
                                           w=w, Br=Br)
    from . import _build

    lib = _build.library()
    pos = torch.empty((R, Br), dtype=torch.int32, device=dev)
    lo = torch.empty((R, Br), dtype=torch.int64, device=dev)
    hi = (torch.empty((R, Br), dtype=torch.int64, device=dev) if k > 32
          else None)
    tot = torch.empty((R,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.dx_values_select(
            _ptr(pc), _ptr(pv), _ptr(mlen), _ptr(allow_short), _ptr(pos),
            _ptr(lo), _ptr(hi) if hi is not None else None, _ptr(tot), R, L,
            k, w, Br, _stream(dev),
        )
    _build.check(err, "values_select launch")
    values_select.launches += 1
    return pos, lo, hi, tot


values_select.launches = 0


# ---------------------------------------------------------------------------
# K4: arch-3 selection into the slot grid
# ---------------------------------------------------------------------------

def select_csum_plain(pc, pv, mlen, allow_short, *, k: int, w: int):
    """The JAX package's select_csum_packed in plain PyTorch, dense.

    Inputs as select_compact_plain. Returns ((R, L) int32 plane, (R,)
    int32 row totals): plane = (in-row inclusive cumsum of the final
    candidate flag << 16) | wp, and the total is the row's flag count."""
    _, wp, flag = _select_plain(pc, pv, mlen, allow_short, k=k, w=w)
    cs = flag.to(torch.int32).cumsum(dim=1, dtype=torch.int32)
    return (cs << 16) | wp.to(torch.int32), cs[:, -1].contiguous()


def csum_slots(pc, plane, tot, *, k: int, Br: int):
    """select_csum_plain's plane -> the slot grid: slot t of row r holds
    the window whose in-row inclusive cumsum first reaches t + 1 (a
    per-row searchsorted of plane >> 16), its wp (plane & 0xFFFF) and the
    canonical value there. Returns ((R, Br) int32 positions, [(R, Br)
    int64 values], (R,) int32 row totals); slots at or past a row's total
    are unspecified."""
    R, L = plane.shape
    t = torch.arange(1, Br + 1, dtype=torch.int32, device=plane.device)
    col = torch.searchsorted((plane >> 16).contiguous(),
                             t[None, :].expand(R, Br).contiguous())
    pos = plane.gather(1, col.clamp_(max=L - 1)) & 0xFFFF
    (canon,) = _canonical_plain(_unpack_codes(pc), k)
    return pos, [canon.gather(1, pos.to(torch.int64))], tot


def select_csum_slots_plain(pc, pv, mlen, allow_short, *, k: int, w: int,
                            Br: int):
    """Plain PyTorch version of K4 (the same function as the kernel):
    csum_slots over select_csum_plain. Returns ((R, Br) int32 positions,
    (R, Br) int64 canonical values, (R,) int32 row totals), as
    select_compact_plain does; slots at or past a row's total are
    unspecified."""
    plane, tot = select_csum_plain(pc, pv, mlen, allow_short, k=k, w=w)
    pos, (val,), tot = csum_slots(pc, plane, tot, k=k, Br=Br)
    return pos, val, tot


def select_csum(pc, pv, mlen, allow_short, *, k: int, w: int, Br: int):
    """K4 wrapper: same arguments and results as select_csum_slots_plain.
    Constraints (the TPU kernel's, and the slot grid's): 1 <= k <= 32,
    128 | L <= 16384, 128 | Br <= L."""
    R, L, dev = _check_tile("select_csum", pc, pv, mlen, allow_short, k,
                            w, Br, 32)
    if dev.type == "cpu":
        return select_csum_slots_plain(pc, pv, mlen, allow_short, k=k, w=w,
                                       Br=Br)
    from . import _build

    lib = _build.library()
    pos = torch.empty((R, Br), dtype=torch.int32, device=dev)
    val = torch.empty((R, Br), dtype=torch.int64, device=dev)
    tot = torch.empty((R,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.dx_select_csum(
            _ptr(pc), _ptr(pv), _ptr(mlen), _ptr(allow_short), _ptr(pos),
            _ptr(val), _ptr(tot), R, L, k, w, Br, _stream(dev),
        )
    _build.check(err, "select_csum launch")
    select_csum.launches += 1
    return pos, val, tot


select_csum.launches = 0


# ---------------------------------------------------------------------------
# K5: forced-v1 selection into the slot grid
# ---------------------------------------------------------------------------

def values_argmin_plain(pc, mlen, *, k: int, w: int):
    """The JAX package's values_argmin_fused in plain PyTorch, dense.

    pc (R, L/4) uint8 packed codes, mlen (R,) int32. Returns (value
    planes, (R, L) int32 wp): the canonical value of the k-mer AT each
    column as int64 planes ([lo] for k <= 32, [lo, hi] above; bases past
    L count as 0 on both strands), and the leftmost window minimum of the
    selection keys over [c, c + w). No validity and no flag: flag_mask
    and a gather at wp follow it (values_argmin_slots_plain)."""
    canon, wp = _values_wp(pc, mlen, k=k, w=w)
    return canon, wp.to(torch.int32)


def values_argmin_slots_plain(pc, pv, mlen, allow_short, *, k: int, w: int,
                              Br: int):
    """Plain PyTorch version of K5 (the same function as the kernel):
    compact_rows over flag_mask and over values_argmin_plain's planes
    gathered at wp. Returns ((R, Br) int32 positions, (R, Br) int64 low
    halves, (R, Br) int64 high halves or None for k <= 32, (R,) int32 row
    totals), as values_select_compact_plain does."""
    planes, wp = values_argmin_plain(pc, mlen, k=k, w=w)
    flag = flag_mask(wp, pv, mlen, allow_short, k=k, w=w)
    at_wp = wp.to(torch.int64)
    pos, planes, tot = compact_rows(
        flag, wp, [p.gather(1, at_wp) for p in planes], Br)
    return pos, planes[0], planes[1] if k > 32 else None, tot


def values_argmin(pc, pv, mlen, allow_short, *, k: int, w: int, Br: int):
    """K5 wrapper: same arguments and results as values_argmin_slots_plain.
    Constraints: 1 <= k <= 56 (the JAX package's forced v1 path), any R,
    128 | L <= 16384, 128 | Br <= L."""
    R, L, dev = _check_tile("values_argmin", pc, pv, mlen, allow_short, k,
                            w, Br, 56)
    if dev.type == "cpu":
        return values_argmin_slots_plain(pc, pv, mlen, allow_short, k=k,
                                         w=w, Br=Br)
    from . import _build

    lib = _build.library()
    pos = torch.empty((R, Br), dtype=torch.int32, device=dev)
    lo = torch.empty((R, Br), dtype=torch.int64, device=dev)
    hi = (torch.empty((R, Br), dtype=torch.int64, device=dev) if k > 32
          else None)
    tot = torch.empty((R,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.dx_values_argmin(
            _ptr(pc), _ptr(pv), _ptr(mlen), _ptr(allow_short), _ptr(pos),
            _ptr(lo), _ptr(hi) if hi is not None else None, _ptr(tot), R, L,
            k, w, Br, _stream(dev),
        )
    _build.check(err, "values_argmin launch")
    values_argmin.launches += 1
    return pos, lo, hi, tot


values_argmin.launches = 0


# ---------------------------------------------------------------------------
# K2: radix-bucket membership + distinct hits per read
# ---------------------------------------------------------------------------

#: queries per gather chunk of the plain K2 (a chunk's bucket rows take
#: chunk * 1 KB, so a production batch stays within a few GB)
PLAIN_PROBE_CHUNK = 1 << 19


def _member_plain(slots: torch.Tensor, bits: int, keys: torch.Tensor):
    rows = slots[lsr(keys, 64 - bits)]
    return (rows == keys[:, None]).any(dim=1)


def probe_hits_plain(slots, spill, keys, srid, first, *, p: int, sp: int,
                     num_segments: int, row_lo: int = 0):
    """Plain PyTorch version of K2.

    slots (rows, 128) int64: bucket rows [row_lo, row_lo + rows) of a
    2**p-row main table (the whole table: row_lo 0, rows 2**p); spill
    (2**sp, 128) int64, the whole spill table, or None when sp == 0; keys
    (q,) int64, srid (q,) int32 (read id, -1 for a filler), first (q,)
    int32: the sorted stream. Returns (num_segments,) int32 distinct
    member keys per read among the queries whose bucket lies in the block
    (a spill match counts only for those), so the hits of the blocks of
    one table sum to the whole table's. Bucket rows are gathered in
    chunks of at most PLAIN_PROBE_CHUNK queries."""
    hits = torch.zeros(num_segments, dtype=torch.int64, device=keys.device)
    q, rows = keys.shape[0], slots.shape[0]
    for a in range(0, q, PLAIN_PROBE_CHUNK):
        ck = keys[a:a + PLAIN_PROBE_CHUNK]
        cs = srid[a:a + PLAIN_PROBE_CHUNK]
        live = (cs >= 0) & (first[a:a + PLAIN_PROBE_CHUNK] != 0)
        b = lsr(ck, 64 - p) - row_lo
        own = (b >= 0) & (b < rows)
        member = (slots[b.clamp(0, rows - 1)] == ck[:, None]).any(dim=1)
        if sp:
            member |= _member_plain(spill, sp, ck)
        sel = live & own & member
        hits.index_add_(
            0, cs[sel].to(torch.int64),
            torch.ones(int(sel.sum()), dtype=torch.int64, device=keys.device),
        )
    return hits.to(torch.int32)


def probe_hits(slots, spill, keys, srid, first, *, p: int, sp: int,
               num_segments: int, row_lo: int = 0):
    """K2 wrapper: same arguments and result as probe_hits_plain. One
    launch per call, so a sharded probe launches once per shard. The
    kernel relies on the stream's order (by key as int64, then srid, as
    prep_sorted sorts it) and on the row order of the port's tables
    (radix_probe._fill_slots); the plain version needs neither."""
    q = keys.shape[0]
    dev = keys.device
    rows = slots.shape[0]
    _require(slots, "table", torch.int64, (rows, 128), dev)
    if sp:
        _require(spill, "spill table", torch.int64, (1 << sp, 128), dev)
    _require(keys, "keys", torch.int64, (q,), dev)
    _require(srid, "srid", torch.int32, (q,), dev)
    _require(first, "first", torch.int32, (q,), dev)
    if not 1 <= p <= 63:
        raise ValueError(f"probe_hits: bad bucket bits p={p}")
    if not (rows >= 1 and row_lo >= 0 and row_lo + rows <= 1 << p):
        raise ValueError(
            f"probe_hits: rows [{row_lo}, {row_lo + rows}) are not a block "
            f"of the 2**{p}-row table"
        )
    if dev.type == "cpu":
        return probe_hits_plain(slots, spill, keys, srid, first, p=p, sp=sp,
                                num_segments=num_segments, row_lo=row_lo)
    if dev.type != "cuda":
        raise ValueError(f"probe_hits: unsupported device {dev}")
    from . import _build

    lib = _build.library()
    hits = torch.zeros(num_segments, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.dx_radix_probe(
            _ptr(keys), _ptr(srid), _ptr(first), q, _ptr(slots), row_lo,
            rows, p, _ptr(spill) if sp else None, sp, _ptr(hits),
            _stream(dev),
        )
    _build.check(err, "radix_probe launch")
    probe_hits.launches += 1
    return hits


probe_hits.launches = 0

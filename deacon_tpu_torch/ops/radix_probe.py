"""Radix-bucket membership table, the sorted probe stream and grid totals.

The index is bucketized by the TOP p BITS of each u64 key (XXH3 hashes are
uniform, so buckets are Poisson-balanced) into K = 128 int64 slots per
bucket; the ~0.1% tail of buckets holding more than 128 keys spills its
excess into a small side table bucketed by the top sp bits. An empty slot
of bucket b holds ((b ^ 1) << (64 - p)), whose bucket is not b, so it can
never equal a query routed to b. Bucket choice, filler and spill geometry
are those of the JAX package's radix table; the port stores whole int64
slots instead of its int8 byte planes (those were a TPU matmul trick).

Tables are built with torch ops on the device of the keys, so a
panhuman-scale key set (~4.1e8 keys) never passes through host NumPy.
A sharded table (build_radix_shards) is cut into blocks of contiguous
bucket rows, each built on its own device from the keys of its rows (a
contiguous slice of the sorted keys), with the same p and the same
replicated spill table as the whole table; the block hits of a query
stream sum to the whole table's (kernels.probe_hits with ``row_lo``).

Reference parity: FxHashSet membership (ref: src/index.rs:96-107) and
distinct-hit counting (ref: src/filter_common.rs:129-155).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .hash import lsr
from .kernels import probe_hits

#: slots per bucket (main and spill tables)
K_SLOTS = 128
#: most bucket rows one device holds: 2**25 rows = 32 GiB of slots
MAX_LOG2_BUCKETS = 25
MAX_SPILL_BITS = 9
_I64_MIN = -(1 << 63)


@dataclass
class RadixTable:
    """A 2**p-row radix table, or one shard of it: slots (rows, 128)
    int64, slot j of bucket row_lo + i in row i (the whole table: rows
    2**p, row_lo 0); spill: the whole (2**sp, 128) int64 spill table or
    None (sp == 0), replicated on every shard. n_keys counts the distinct
    keys of the shard's bucket rows (stored here or in the spill)."""

    slots: torch.Tensor
    p: int
    n_keys: int
    spill: torch.Tensor | None = None
    sp: int = 0
    row_lo: int = 0

    @property
    def nbytes(self) -> int:
        n = self.slots.numel() * 8
        return n + (self.spill.numel() * 8 if self.spill is not None else 0)


def choose_p(n: int) -> int:
    """Bucket bits: the smallest p with expected load <= 80; above 2**22
    rows, one level fewer when the load stays <= 100 (the overflowing
    Poisson tail then goes to the spill table). Floor 5."""
    p = 5
    while (n >> p) > 80:
        p += 1
    if p > 22 and (n >> (p - 1)) <= 100:
        p -= 1
    return p


def _bucket_of(keys: torch.Tensor, bits: int) -> torch.Tensor:
    return lsr(keys, 64 - bits)


def _fill_slots(keys: torch.Tensor, bits: int, row_lo: int = 0,
                rows: int | None = None):
    """(rows, 128) slot block of bucket rows [row_lo, row_lo + rows)
    (default: all 2**bits) from the unsigned-ascending keys of those rows,
    plus the keys whose rank in their bucket is >= 128 (in the same
    order).

    Row order, which K2's kernel relies on: the c keys of bucket b sit
    ascending as u64 in slots 0..c-1 and its filler fills slots c..127,
    so a bucket has keys past slot 127 (spill keys) only when its row is
    full (slot 127 holds a key of b), and each is above that key. The
    JAX package's _pack_planes lays rows out the same way."""
    nb = (1 << bits) if rows is None else rows
    dev = keys.device
    b = _bucket_of(keys, bits) - row_lo
    starts = torch.searchsorted(b, torch.arange(nb, device=dev))
    j = torch.arange(keys.numel(), device=dev) - starts[b]
    del starts
    keep = j < K_SLOTS
    overflow = keys[~keep]
    empty = ((torch.arange(nb, dtype=torch.int64, device=dev) + row_lo)
             ^ 1) << (64 - bits)
    slots = empty[:, None].repeat(1, K_SLOTS)
    slots.view(-1)[(b * K_SLOTS + j)[keep]] = keys[keep]
    return slots, overflow


def _pack_spill(spill_keys: torch.Tensor):
    """(spill table, sp), or None when even sp = MAX_SPILL_BITS cannot
    hold the fullest spill bucket."""
    n = spill_keys.numel()
    sp = 7
    while (n >> sp) > 64 and sp < MAX_SPILL_BITS:
        sp += 1
    while sp <= MAX_SPILL_BITS:
        counts = torch.bincount(_bucket_of(spill_keys, sp), minlength=1 << sp)
        if int(counts.max()) <= K_SLOTS:
            slots, rest = _fill_slots(spill_keys, sp)
            assert rest.numel() == 0
            return slots, sp
        sp += 1
    return None


def sorted_unique_keys(keys: torch.Tensor) -> torch.Tensor:
    """Distinct int64 keys in unsigned ascending order (sorting the keys
    with their sign bit flipped orders them as u64)."""
    s = torch.sort(keys.reshape(-1) ^ _I64_MIN).values
    if s.numel() > 1:
        head = torch.ones(1, dtype=torch.bool, device=s.device)
        s = s[torch.cat([head, s[1:] != s[:-1]])]
    return s ^ _I64_MIN


def _is_sorted_unique(keys: torch.Tensor, chunk: int = 1 << 24) -> bool:
    """Whether int64 keys are strictly ascending as u64 (checked in chunks,
    so no temporary is as large as the keys)."""
    for a in range(0, keys.numel() - 1, chunk):
        f = keys[a:a + chunk + 1] ^ _I64_MIN
        if not bool((f[1:] > f[:-1]).all()):
            return False
    return True


def _row_start(keys: torch.Tensor, bits: int, row: int) -> int:
    """Index of the first of the unsigned-ascending keys whose bucket is
    at least ``row`` (a binary search of scalar reads)."""
    if row <= 0:
        return 0
    lo, hi = 0, keys.numel()
    while lo < hi:
        mid = (lo + hi) // 2
        if (int(keys[mid]) & ((1 << 64) - 1)) >> (64 - bits) < row:
            lo = mid + 1
        else:
            hi = mid
    return lo


def build_radix_shards(keys, n_shard: int, devices) -> list[RadixTable]:
    """The radix table of the distinct keys of an int64 tensor or a uint64
    array, cut into n_shard blocks of bucket rows: shard j holds rows
    [j * 2**p // n_shard, (j + 1) * 2**p // n_shard) on devices[j], built
    there from the keys of those rows. p, the spill rule and the retry at
    p + 1 are build_radix_table's, so the blocks' slots concatenated are
    its slots and every shard holds its spill table. Keys that are already
    sorted and distinct (an index file's) are used in place, others are
    sorted on devices[0]; no device holds more than its block, the spill
    and its slice of the keys besides those keys. Raises
    NotImplementedError when a shard would hold more than
    2**MAX_LOG2_BUCKETS rows."""
    devices = [torch.device(d) for d in devices]
    if len(devices) != n_shard or n_shard < 1:
        raise ValueError(f"need one device for each of {n_shard} shards, "
                         f"got {len(devices)}")
    if isinstance(keys, np.ndarray):
        keys = torch.from_numpy(
            np.ascontiguousarray(keys, dtype=np.uint64).view(np.int64))
    keys = keys.reshape(-1).to(torch.int64)
    if not _is_sorted_unique(keys):
        keys = sorted_unique_keys(keys.to(devices[0]))
    n = keys.numel()
    p = choose_p(n)
    if n_shard > 1 << p:
        raise ValueError(f"{n_shard} shards: the table of {n} keys has only "
                         f"2**{p} bucket rows")
    while True:
        if -(-(1 << p) // n_shard) > 1 << MAX_LOG2_BUCKETS:
            hint = (" on one card: shard the table across cards with "
                    "--mesh 1xN" if n_shard == 1 else " in a shard: use "
                    "more shards")
            raise NotImplementedError(
                f"{n} index keys need more than 2**{MAX_LOG2_BUCKETS} radix "
                f"buckets{hint}"
            )
        shards, over = [], []
        for j, dev in enumerate(devices):
            r0, r1 = j * (1 << p) // n_shard, (j + 1) * (1 << p) // n_shard
            part = keys[_row_start(keys, p, r0):_row_start(keys, p, r1)]
            slots, rest = _fill_slots(part.to(dev), p, r0, r1 - r0)
            shards.append(RadixTable(slots, p, part.numel(), row_lo=r0))
            over.append(rest.to(devices[0]))
        spill_keys = torch.cat(over)
        if spill_keys.numel() == 0:
            return shards
        packed = _pack_spill(spill_keys)
        if packed is not None:
            for t in shards:
                t.spill = packed[0].to(t.slots.device)
                t.sp = packed[1]
            return shards
        del shards, over
        p += 1  # extreme skew (not for real hashes): split finer


def build_radix_table(keys: torch.Tensor) -> RadixTable:
    """Table of the distinct keys of an int64 tensor (u64 bit patterns),
    built on the keys' device (build_radix_shards with one shard). Raises
    NotImplementedError when the table would need more than
    2**MAX_LOG2_BUCKETS buckets."""
    return build_radix_shards(keys, 1, [keys.device])[0]


def radix_table_from_jax(planes: np.ndarray, p: int, k: int,
                         spill: np.ndarray | None, sp: int) -> RadixTable:
    """The JAX package's RadixTable arrays (given as NumPy) as the port's
    slot tables. Byte plane b of slot j sits in column b*k + j; top key
    bytes not stored are implied by the bucket id."""
    nb = 1 << p
    npl = planes.shape[1] // k
    by = planes.view(np.uint8).reshape(nb, npl, k).astype(np.uint64)
    slots = np.zeros((nb, k), dtype=np.uint64)
    for b in range(npl):
        slots |= by[:, b, :] << np.uint64(8 * b)
    if npl < 8:
        implied = ~np.uint64((1 << (8 * npl)) - 1)
        bucket_bits = np.arange(nb, dtype=np.uint64) << np.uint64(64 - p)
        slots |= (bucket_bits & implied)[:, None]
    # a slot holds a key exactly when its bucket is its row (fillers
    # carry bucket b ^ 1)
    n_keys = _count_stored(slots, p)
    sp_slots = None
    if sp:
        sby = spill.view(np.uint8).reshape(1 << sp, 8, K_SLOTS).astype(np.uint64)
        sp_np = np.zeros((1 << sp, K_SLOTS), dtype=np.uint64)
        for b in range(8):
            sp_np |= sby[:, b, :] << np.uint64(8 * b)
        n_keys += _count_stored(sp_np, sp)
        sp_slots = torch.from_numpy(sp_np.view(np.int64))
    return RadixTable(
        torch.from_numpy(slots.view(np.int64)), p, n_keys,
        sp_slots, sp,
    )


def _count_stored(slots: np.ndarray, bits: int) -> int:
    rows = np.arange(slots.shape[0], dtype=np.uint64)[:, None]
    return int(np.count_nonzero((slots >> np.uint64(64 - bits)) == rows))


def prep_sorted(hashes: torch.Tensor, slot_valid: torch.Tensor,
                rid_slots: torch.Tensor):
    """Flatten the (R, Br) slot grids into the probe stream: srid = read
    id for a valid slot and -1 for a filler, sorted by (key, srid) with
    two stable sorts; first marks each new (key, srid) run."""
    q = hashes.numel()
    sv = slot_valid.reshape(q)
    srid = torch.where(sv, rid_slots.reshape(q).to(torch.int32), -1)
    key = torch.where(sv, hashes.reshape(q), -1)
    o1 = torch.argsort(srid, stable=True)
    key, srid = key[o1], srid[o1]
    o2 = torch.argsort(key, stable=True)
    key, srid = key[o2], srid[o2]
    first = torch.ones(q, dtype=torch.int32, device=key.device)
    if q > 1:
        first[1:] = ((key[1:] != key[:-1]) | (srid[1:] != srid[:-1])).to(
            torch.int32
        )
    return key.contiguous(), srid.contiguous(), first


def radix_probe_hits(tables, hashes, slot_valid, rid_slots, *,
                     num_segments: int) -> torch.Tensor:
    """(num_segments,) int32 distinct member hashes per read unit: the
    sorted stream of prep_sorted through K2 once for each of ``tables``
    ([the whole table], or the shards of one, each on its device: the
    stream goes there and its hits come back to the stream's device,
    where they are summed). Exact on any batch in one pass (no window
    sizing, no overflow, no rerun)."""
    key, srid, first = prep_sorted(hashes, slot_valid, rid_slots)
    home = key.device
    total = None
    for t in tables:
        dev = t.slots.device
        hits = probe_hits(
            t.slots, t.spill, key.to(dev, non_blocking=True),
            srid.to(dev, non_blocking=True), first.to(dev, non_blocking=True),
            p=t.p, sp=t.sp, num_segments=num_segments, row_lo=t.row_lo,
        ).to(home, non_blocking=True)
        total = hits if total is None else total + hits
    return total


def totals_grid(slot_pos, slot_valid, rid, mate, cstart, *,
                num_segments: int, k: int, l: int, stride: int,
                dedup_positions: bool) -> torch.Tensor:
    """Per-unit totals from the (R, Br) slot grids: distinct (mate, global
    position) per unit. Duplicates arise only from long-read chunk
    overlap: the same position re-selected in the following
    OVR = ceil((l-1)/stride) rows of the same (unit, mate), always within
    a row's first S = roundup8(l-k+1) slots, so those are compared against
    the previous OVR rows' slots. Sums use integer index_add_."""
    R, Br = slot_pos.shape
    valid = slot_valid.reshape(R, Br)
    row_tot = valid.sum(dim=1)
    if dedup_positions and R > 1:
        ovr = min(max(1, -(-(l - 1) // max(stride, 1))), R - 1)
        s_pref = min(Br, ((l - k + 1 + 7) // 8) * 8) if l > k else 8
        gpos = cstart.to(torch.int64)[:, None] + slot_pos.to(torch.int64)
        pref, pref_valid = gpos[:, :s_pref], valid[:, :s_pref]
        dup = torch.zeros((R, s_pref), dtype=torch.bool, device=valid.device)
        for o in range(1, ovr + 1):
            same = (rid[o:] == rid[:-o]) & (mate[o:] == mate[:-o])
            eq = (
                (pref[o:, :, None] == gpos[:-o, None, :])
                & pref_valid[o:, :, None] & valid[:-o, None, :]
            )
            dup[o:] |= eq.any(dim=2) & same[:, None]
        row_tot = row_tot - dup.sum(dim=1)
    out = torch.zeros(num_segments, dtype=torch.int64, device=valid.device)
    out.index_add_(0, rid.to(torch.int64), row_tot)
    return out.to(torch.int32)

"""K1-K5 on the card against their plain PyTorch versions, exact (K2 in
its sharded form too, its blocks' hits summing to the whole table's), and
the pipeline, the sharded pipeline and the index build on the card
against the CPU or the unsharded pipeline, under the engine's switches
too.

Marked ``cuda``: each test asks a fixture whether a card is present and
skips without one (the decision is never taken at import or collection,
so every pytest-xdist worker collects the same tests). On a machine with
an H100: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from deacon_tpu_torch.ops import kernels as tk
from deacon_tpu_torch.ops import pack as tpack
from deacon_tpu_torch.ops import radix_probe as trp
from deacon_tpu_torch.ops.engine import DevicePipeline

pytestmark = pytest.mark.cuda

_B = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def k1_edge_rows(rng, L, k, w):
    """Eight rows the K1 kernel's design can get wrong, appended after a
    tile's random rows (so R grows by 8 and stays a multiple of 8 where it
    was one): all-invalid; unused (mlen -1); a homopolymer whose every
    window is selected (its total exceeds the slot budget past L = 128);
    one window through allow_short (mlen 1); and four full-length rows
    (mlen = L - k + 1, the last k-mer ending on the row's last base; the
    tile's last row among them), three of them with constant stretches at
    periods 29, 32 and 37, which put window minima on thread-run and warp
    boundaries. tests/test_torch_ops.py holds the plain version against
    the JAX package on the same rows."""
    full = L - k + 1
    codes = rng.integers(0, 4, (8, L)).astype(np.uint8)
    validb = np.ones((8, L), dtype=bool)
    mlen = np.full(8, full, dtype=np.int32)
    allow = np.zeros(8, dtype=bool)
    validb[0] = False
    mlen[1] = -1
    codes[2] = 2
    mlen[3] = 1
    allow[3] = True
    for r, (s0, step) in zip((5, 6, 7), ((3, 29), (0, 32), (17, 37))):
        for j, s in enumerate(range(s0, L, step)):
            codes[r, s:s + k + w + 2] = j % 4
            validb[r, s + k + w + 2:s + k + w + 3] = j % 3 != 0
    return codes, validb, mlen, allow


def _tile(rng, R, L, k, w, edge=False):
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    validb = rng.random((R, L)) > 0.03
    mlen = rng.integers(-1, L - k + 2, (R,)).astype(np.int32)
    mlen[0] = L - k + 1
    mlen[2] = max(1, w - 2)
    allow = rng.random(R) > 0.5
    allow[2] = True
    if edge:
        codes, validb, mlen, allow = (
            np.concatenate([a, e]) for a, e in
            zip((codes, validb, mlen, allow), k1_edge_rows(rng, L, k, w)))
        R += 8
    c = codes.reshape(R, L // 4, 4)
    pc = c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)
    pv = np.packbits(validb, axis=1, bitorder="little")
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (pc, pv, mlen, allow)]


@pytest.mark.parametrize("k,w,L,R", [
    (31, 15, 256, 64), (32, 7, 2048, 16), (21, 11, 16384, 8), (5, 3, 128, 8),
    (31, 15, 16384, 512),
    # the edges of the O(1) design: k = 1 and 32, w = 1 and wider than a
    # thread's run or a warp (33, 63), padded runs (L = 128, 384, 1152)
    (1, 15, 256, 16), (32, 15, 256, 16), (31, 1, 256, 16), (31, 33, 256, 16),
    (15, 63, 2048, 8), (32, 63, 128, 9), (1, 1, 128, 8), (7, 33, 384, 8),
    (31, 15, 1152, 8), (13, 63, 16384, 8), (32, 5, 12288, 8),
])
def test_k1_kernel_matches_plain(cuda, k, w, L, R):
    rng = np.random.default_rng(k + w + L)
    Br = tpack.v4_row_budget(L, w, tpack.default_budget_frac(w))
    args = [a.to(cuda) for a in _tile(rng, R, L, k, w, edge=True)]
    pos, val, tot = tk.select_compact(*args, k=k, w=w, Br=Br)
    ppos, pval, ptot = tk.select_compact_plain(*args, k=k, w=w, Br=Br)
    torch.cuda.synchronize()
    assert torch.equal(tot, ptot)
    live = torch.arange(Br, device=cuda)[None, :] < tot.clamp(max=Br)[:, None]
    assert torch.equal(pos[live], ppos[live])
    assert torch.equal(val[live], pval[live])
    assert int(tot.sum()) > 0
    if L > 128:
        assert bool((tot > Br).any())  # the homopolymer row overflows


def test_k1_kernel_unaligned_inputs_match_plain(cuda):
    """Packed inputs that do not start on a 16-byte boundary take the
    kernel's byte-wise staging path."""
    k, w, L, R = 31, 15, 256, 16
    rng = np.random.default_rng(5)
    Br = tpack.v4_row_budget(L, w, tpack.default_budget_frac(w))
    pc, pv, mlen, allow = [a.to(cuda) for a in
                           _tile(rng, R, L, k, w, edge=True)]
    pcu = torch.empty(pc.numel() + 1, dtype=torch.uint8, device=cuda)
    pvu = torch.empty(pv.numel() + 1, dtype=torch.uint8, device=cuda)
    pcu = pcu[1:].view(pc.shape).copy_(pc)
    pvu = pvu[1:].view(pv.shape).copy_(pv)
    got = tk.select_compact(pcu, pvu, mlen, allow, k=k, w=w, Br=Br)
    want = tk.select_compact_plain(pc, pv, mlen, allow, k=k, w=w, Br=Br)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])
    live = (torch.arange(Br, device=cuda)[None, :]
            < got[2].clamp(max=Br)[:, None])
    for g, x in zip(got[:2], want[:2]):
        assert torch.equal(g[live], x[live])


def _slots_check(got, want, Br):
    """A slot grid against its plain version's: totals exactly, and every
    live slot's position and value halves exactly. got and want are
    (pos, lo, hi, tot) (K3, K5) or (pos, val, tot) (K1, K4)."""
    if len(got) == 3:
        got, want = (g[:2] + (None,) + g[2:] for g in (got, want))
    pos, lo, hi, tot = got
    ppos, plo, phi, ptot = want
    assert torch.equal(tot, ptot)
    assert (hi is None) == (phi is None)
    live = (torch.arange(Br, device=tot.device)[None, :]
            < tot.clamp(max=Br)[:, None])
    assert torch.equal(pos[live], ppos[live])
    assert torch.equal(lo[live], plo[live])
    if hi is not None:
        assert torch.equal(hi[live], phi[live])
    assert int(tot.sum()) > 0


@pytest.mark.parametrize("k,w,L,R,Br,edge", [
    (41, 15, 256, 64, None, False), (56, 9, 2048, 16, None, False),
    (57, 15, 16384, 8, None, False), (31, 15, 2048, 16, None, False),
    (41, 15, 16384, 512, None, False),
    # k at the 64-bit/128-bit edge and at the top, with the edge rows
    (33, 15, 256, 16, None, True), (56, 15, 1152, 8, None, True),
    (57, 9, 384, 8, None, True), (32, 15, 256, 16, None, True),
    # w = 1: every column selected, totals past Br
    (41, 1, 256, 16, None, True), (57, 1, 2048, 8, 128, True),
    (21, 1, 1152, 8, None, True),
    # L = 128 and 16384; R not a multiple of 8; Br = 128 and Br = L
    (33, 7, 128, 8, 128, True), (57, 63, 128, 9, None, True),
    (41, 15, 128, 5, 128, True), (56, 33, 4096, 13, 4096, True),
    (41, 15, 16384, 3, 16384, True), (57, 15, 16384, 8, 128, True),
    (21, 11, 16384, 5, None, True), (45, 20, 640, 7, 128, True),
])
def test_k3_kernel_matches_plain(cuda, k, w, L, R, Br, edge):
    rng = np.random.default_rng(k + w + L + 1)
    if Br is None:
        Br = tpack.v4_row_budget(L, w, tpack.default_budget_frac(w))
    args = [a.to(cuda) for a in _tile(rng, R, L, k, w, edge=edge)]
    got = tk.values_select(*args, k=k, w=w, Br=Br)
    want = tk.values_select_compact_plain(*args, k=k, w=w, Br=Br)
    torch.cuda.synchronize()
    _slots_check(got, want, Br)
    if edge and Br < L:
        assert bool((got[3] > Br).any())  # the homopolymer row overflows


@pytest.mark.parametrize("k", [31, 41, 57])
def test_k3_kernel_unaligned_inputs_match_plain(cuda, k):
    """Packed inputs that do not start on a 16-byte boundary take the
    kernel's byte-wise staging path."""
    w, L, R = 15, 256, 16
    rng = np.random.default_rng(k + 6)
    Br = tpack.v4_row_budget(L, w, tpack.default_budget_frac(w))
    pc, pv, mlen, allow = [a.to(cuda) for a in
                           _tile(rng, R, L, k, w, edge=True)]
    pcu = torch.empty(pc.numel() + 1, dtype=torch.uint8, device=cuda)
    pvu = torch.empty(pv.numel() + 1, dtype=torch.uint8, device=cuda)
    pcu = pcu[1:].view(pc.shape).copy_(pc)
    pvu = pvu[1:].view(pv.shape).copy_(pv)
    got = tk.values_select(pcu, pvu, mlen, allow, k=k, w=w, Br=Br)
    want = tk.values_select_compact_plain(pc, pv, mlen, allow, k=k, w=w,
                                          Br=Br)
    torch.cuda.synchronize()
    _slots_check(got, want, Br)


@pytest.mark.parametrize("k,w,L,R,Br", [
    # the K4 tiles (non-power-of-two L) and small ones
    (31, 15, 384, 4096, None), (31, 15, 1152, 64, None),
    (31, 15, 12288, 32, None), (15, 5, 1152, 16, None), (32, 7, 256, 8, None),
    (5, 3, 128, 8, None),
    # K1's edges: k = 1 and 32, w = 1, 33 and 63, padded runs (L = 384,
    # 1152, 12288); R not a multiple of 8; Br = 128 and Br = L
    (1, 15, 384, 16, None), (32, 15, 384, 16, None), (31, 1, 1152, 8, None),
    (31, 33, 384, 16, None), (15, 63, 1152, 8, None), (32, 63, 128, 9, None),
    (1, 1, 128, 8, None), (7, 33, 384, 8, None), (13, 63, 12288, 8, None),
    (32, 5, 12288, 8, None), (31, 15, 640, 5, 640), (21, 11, 1152, 3, 128),
])
def test_k4_kernel_matches_plain(cuda, k, w, L, R, Br):
    rng = np.random.default_rng(k + w + L + 2)
    if Br is None:
        Br = tpack.v4_row_budget(L, w, tpack.default_budget_frac(w))
    args = [a.to(cuda) for a in _tile(rng, R, L, k, w, edge=True)]
    got = tk.select_csum(*args, k=k, w=w, Br=Br)
    want = tk.select_csum_slots_plain(*args, k=k, w=w, Br=Br)
    torch.cuda.synchronize()
    _slots_check(got, want, Br)
    if Br < L:
        assert bool((got[2] > Br).any())  # the homopolymer row overflows


@pytest.mark.parametrize("k,w,L,R,Br,edge", [
    (31, 15, 256, 64, None, False), (41, 15, 2048, 16, None, False),
    (56, 9, 2048, 16, None, False), (21, 11, 16384, 8, None, False),
    (41, 15, 16384, 64, None, False), (5, 3, 128, 8, None, False),
    # K3's list up to k = 56: its main-path tiles, then its edges with the
    # edge rows
    (41, 15, 256, 64, None, False), (31, 15, 2048, 16, None, False),
    (41, 15, 16384, 512, None, False),
    (33, 15, 256, 16, None, True), (56, 15, 1152, 8, None, True),
    (56, 9, 384, 8, None, True), (32, 15, 256, 16, None, True),
    (41, 1, 256, 16, None, True), (56, 1, 2048, 8, 128, True),
    (21, 1, 1152, 8, None, True),
    # L = 128 and 16384; R not a multiple of 8; Br = 128 and Br = L
    (33, 7, 128, 8, 128, True), (56, 63, 128, 9, None, True),
    (41, 15, 128, 5, 128, True), (56, 33, 4096, 13, 4096, True),
    (41, 15, 16384, 3, 16384, True), (56, 15, 16384, 8, 128, True),
    (21, 11, 16384, 5, None, True), (45, 20, 640, 7, 128, True),
])
def test_k5_kernel_matches_plain(cuda, k, w, L, R, Br, edge):
    rng = np.random.default_rng(k + w + L + 3)
    if Br is None:
        Br = tpack.v4_row_budget(L, w, tpack.default_budget_frac(w))
    args = [a.to(cuda) for a in _tile(rng, R, L, k, w, edge=edge)]
    got = tk.values_argmin(*args, k=k, w=w, Br=Br)
    want = tk.values_argmin_slots_plain(*args, k=k, w=w, Br=Br)
    torch.cuda.synchronize()
    _slots_check(got, want, Br)
    if edge and Br < L:
        assert bool((got[3] > Br).any())  # the homopolymer row overflows


@pytest.mark.parametrize("kernel,k", [("K4", 31), ("K5", 31), ("K5", 41)])
def test_k4_k5_kernel_unaligned_inputs_match_plain(cuda, kernel, k):
    """Packed inputs that do not start on a 16-byte boundary take the
    byte-wise staging path of K4's and K5's instantiations too."""
    w, L, R = 15, 384, 16
    rng = np.random.default_rng(k + 8)
    Br = tpack.v4_row_budget(L, w, tpack.default_budget_frac(w))
    pc, pv, mlen, allow = [a.to(cuda) for a in
                           _tile(rng, R, L, k, w, edge=True)]
    pcu = torch.empty(pc.numel() + 1, dtype=torch.uint8, device=cuda)
    pvu = torch.empty(pv.numel() + 1, dtype=torch.uint8, device=cuda)
    pcu = pcu[1:].view(pc.shape).copy_(pc)
    pvu = pvu[1:].view(pv.shape).copy_(pv)
    wrapper, plain = {
        "K4": (tk.select_csum, tk.select_csum_slots_plain),
        "K5": (tk.values_argmin, tk.values_argmin_slots_plain)}[kernel]
    got = wrapper(pcu, pvu, mlen, allow, k=k, w=w, Br=Br)
    want = plain(pc, pv, mlen, allow, k=k, w=w, Br=Br)
    torch.cuda.synchronize()
    _slots_check(got, want, Br)


@pytest.mark.parametrize("spill", [False, True])
def test_k2_kernel_matches_plain(cuda, spill):
    g = torch.Generator(device=cuda).manual_seed(7)
    keys = torch.randint(-(1 << 63), (1 << 63) - 1, (1 << 20,), device=cuda,
                         dtype=torch.int64, generator=g)
    if spill:
        top = keys[3] & ~((1 << 36) - 1)
        keys = torch.cat([keys, top | torch.randint(
            0, 1 << 36, (180,), device=cuda, generator=g)])
    t = trp.build_radix_table(keys)
    assert (t.sp > 0) == spill
    R, Br = 512, 384
    pick = torch.randint(0, keys.numel(), (R * Br,), device=cuda, generator=g)
    other = torch.randint(-(1 << 63), (1 << 63) - 1, (R * Br,), device=cuda,
                          dtype=torch.int64, generator=g)
    coin = torch.rand(R * Br, device=cuda, generator=g) < 0.5
    hashes = torch.where(coin, keys[pick], other).reshape(R, Br)
    valid = torch.rand((R, Br), device=cuda, generator=g) < 0.67
    rid = torch.arange(R, device=cuda, dtype=torch.int32) // 4
    key, srid, first = trp.prep_sorted(hashes, valid,
                                       rid[:, None].expand(R, Br))
    kw = dict(p=t.p, sp=t.sp, num_segments=R // 4)
    got = tk.probe_hits(t.slots, t.spill, key, srid, first, **kw)
    want = tk.probe_hits_plain(t.slots, t.spill, key, srid, first, **kw)
    assert torch.equal(got, want)
    assert int(want.sum()) > 0


@pytest.mark.parametrize("n_shard", [3, 4])
def test_k2_sharded_kernel_matches_plain_and_whole_table(cuda, n_shard):
    g = torch.Generator(device=cuda).manual_seed(11)
    keys = torch.randint(-(1 << 63), (1 << 63) - 1, (1 << 20,), device=cuda,
                         dtype=torch.int64, generator=g)
    top = keys[5] & ~((1 << 36) - 1)
    keys = torch.cat([keys, top | torch.randint(
        0, 1 << 36, (180,), device=cuda, generator=g)])
    whole = trp.build_radix_table(keys)
    shards = trp.build_radix_shards(keys, n_shard, [cuda] * n_shard)
    assert whole.sp > 0 and all(t.sp == whole.sp for t in shards)
    assert torch.equal(torch.cat([t.slots for t in shards]), whole.slots)
    R, Br = 512, 384
    pick = torch.randint(0, keys.numel(), (R * Br,), device=cuda, generator=g)
    other = torch.randint(-(1 << 63), (1 << 63) - 1, (R * Br,), device=cuda,
                          dtype=torch.int64, generator=g)
    coin = torch.rand(R * Br, device=cuda, generator=g) < 0.5
    hashes = torch.where(coin, keys[pick], other).reshape(R, Br)
    valid = torch.rand((R, Br), device=cuda, generator=g) < 0.67
    rid = torch.arange(R, device=cuda, dtype=torch.int32) // 4
    key, srid, first = trp.prep_sorted(hashes, valid,
                                       rid[:, None].expand(R, Br))
    kw = dict(p=whole.p, sp=whole.sp, num_segments=R // 4)
    tk.probe_hits.launches = 0
    per = []
    for t in shards:
        got = tk.probe_hits(t.slots, t.spill, key, srid, first,
                            row_lo=t.row_lo, **kw)
        want = tk.probe_hits_plain(t.slots, t.spill, key, srid, first,
                                   row_lo=t.row_lo, **kw)
        assert torch.equal(got, want)
        per.append(got)
    assert tk.probe_hits.launches == n_shard
    whole_hits = tk.probe_hits(whole.slots, whole.spill, key, srid, first,
                               **kw)
    assert torch.equal(sum(per), whole_hits) and int(whole_hits.sum()) > 0


#: K2's edge cases: each is a table and a sorted stream made from a seeded
#: numpy generator (see _k2_case)
K2_CASES = ["empty", "ragged", "all_filler", "spill_planted",
            "key_minus_one", "p5", "p22", "repeat_heavy", "unaligned"]


def _k2_table(keys, dev, p=None):
    """The radix table of the distinct u64 keys, built on dev; at bucket
    bits p when given (through the builder's own _fill_slots and
    _pack_spill), else at choose_p's."""
    t = torch.from_numpy(np.unique(keys).view(np.int64)).to(dev)
    if p is None:
        return trp.build_radix_table(t)
    slots, over = trp._fill_slots(t, p)
    spill, sp = trp._pack_spill(over) if over.numel() else (None, 0)
    return trp.RadixTable(slots, p, t.numel(), spill, sp)


def _k2_case(name, dev, p22=22):
    """(table, key, srid, first, num_segments) of one K2_CASES case on dev:
    empty (q = 0); ragged (q = 37 x 29, not a multiple of the 32-entry
    tile); all_filler (every slot a filler); spill_planted (a full bucket
    with spill keys: its last main key, its first and last spilled keys
    and two absent keys of the bucket, planted several times in one read
    and once in others); key_minus_one (index and queries hold u64 max, 0
    and u64 max - 1, next to a filler run); p5 (a 2,200-key table at p =
    5 with a spill); p22 (a sparse table forced to p = p22, most rows
    empty); repeat_heavy (one read holds most of the live member keys);
    unaligned (spill_planted's inputs with the tables moved to 8-byte
    aligned storage, which the kernel reads 8 bytes at a time)."""
    if name == "unaligned":
        t, key, srid, first, nseg = _k2_case("spill_planted", dev)
        return (trp.RadixTable(_misaligned(t.slots), t.p, t.n_keys,
                               _misaligned(t.spill), t.sp),
                key, srid, first, nseg)
    rng = np.random.default_rng(K2_CASES.index(name) + 60)
    n = {"p5": 2000, "p22": 1 << 20, "repeat_heavy": 1 << 20,
         "spill_planted": 200_000}.get(name, 50_000)
    keys = np.unique(rng.integers(0, 2**64, n, dtype=np.uint64))
    low = 58 if name == "p5" else 36  # the planted bucket's free bits
    top = int(keys[n // 2]) & ~((1 << low) - 1)
    planted = np.uint64(top) | rng.integers(0, 1 << low, 200 if name == "p5"
                                             else 180, dtype=np.uint64)
    extra = ([2**64 - 1, 2**64 - 2, 0] if name == "key_minus_one" else [])
    keys = np.unique(np.concatenate([keys, planted,
                                     np.array(extra, dtype=np.uint64)]))
    t = _k2_table(keys, dev, p22 if name == "p22" else None)
    R, Br, per_read = {"empty": (0, 8, 1), "ragged": (37, 29, 1),
                       "repeat_heavy": (64, 1024, 1)}.get(name, (128, 96, 2))
    qk = np.where(rng.random((R, Br)) < 0.5, rng.choice(keys, (R, Br)),
                  rng.integers(0, 2**64, (R, Br), dtype=np.uint64))
    valid = rng.random((R, Br)) < 0.67
    rid = np.arange(R, dtype=np.int32) // per_read
    if name == "all_filler":
        valid[:] = False
    if name == "spill_planted":
        b = np.sort(keys[(keys >> np.uint64(64 - t.p)) == (top >> (64 - t.p))])
        assert b.size > 128 and t.sp > 0
        # slot 127's key, the first and last spilled keys, a key absent
        # between slots 126 and 127 and one above every key of the bucket
        plant = [b[127], b[128], b[-1], b[126] + np.uint64(1), b[-1] + np.uint64(1)]
        for j, kv in enumerate(plant):
            qk[0, 3 * j:3 * j + 3] = kv
            qk[10 + j, j] = kv
        valid[0, :15] = True
        valid[10:15] = True
    if name == "key_minus_one":
        for r, kv in ((1, 2**64 - 1), (2, 2**64 - 1), (5, 2**64 - 1),
                      (6, 0), (7, 2**64 - 2), (9, 2**64 - 3)):
            qk[r, :4] = kv
            valid[r, :4] = True
    if name == "repeat_heavy":
        qk[:56] = rng.choice(keys, 56 * Br, replace=False).reshape(56, Br)
        rid = np.concatenate([np.zeros(56, np.int32),
                              np.arange(1, R - 55, dtype=np.int32)])
    nseg = max(int(rid.max()) + 1, 1) if R else 4
    hashes = torch.from_numpy(qk.view(np.int64)).to(dev)
    rid_t = torch.from_numpy(rid).to(dev)
    key, srid, first = trp.prep_sorted(hashes, torch.from_numpy(valid).to(dev),
                                       rid_t[:, None].expand(R, Br))
    return t, key, srid, first, nseg


def _misaligned(x):
    """A contiguous copy of x whose data starts 8 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 2, dtype=x.dtype, device=x.device)
    off = 1 if buf.data_ptr() % 16 == 0 else 2
    y = buf[off:off + x.numel()].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == 8
    return y


def _k2_shards(t, n_shard):
    """The table's blocks of bucket rows for n_shard shards, as
    build_radix_shards cuts them (tests/test_torch_sharded.py holds the
    two equal)."""
    rows = 1 << t.p
    return [trp.RadixTable(t.slots[j * rows // n_shard:
                                   (j + 1) * rows // n_shard],
                           t.p, 0, t.spill, t.sp, row_lo=j * rows // n_shard)
            for j in range(n_shard)]


@pytest.mark.parametrize("name", K2_CASES)
def test_k2_kernel_edge_cases_match_plain_and_whole_table(cuda, name):
    t, key, srid, first, nseg = _k2_case(name, cuda)
    kw = dict(p=t.p, sp=t.sp, num_segments=nseg)
    got = tk.probe_hits(t.slots, t.spill, key, srid, first, **kw)
    want = tk.probe_hits_plain(t.slots, t.spill, key, srid, first, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (int(want.sum()) > 0) == (name not in ("empty", "all_filler"))
    if name == "repeat_heavy":
        assert int(want[0]) > int(want.sum()) // 2
    for n_shard in (3, 4):
        per = []
        for s in _k2_shards(t, n_shard):
            h = tk.probe_hits(s.slots, s.spill, key, srid, first,
                              row_lo=s.row_lo, **kw)
            assert torch.equal(h, tk.probe_hits_plain(
                s.slots, s.spill, key, srid, first, row_lo=s.row_lo, **kw))
            per.append(h)
        assert torch.equal(sum(per), got)


def test_sharded_pipeline_on_card_matches_device_pipeline(cuda):
    from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes
    from deacon_tpu_torch.parallel.sharded import make_mesh

    rng = np.random.default_rng(6)
    genome = rng.choice(_B, size=200_000).tobytes()
    idx = np.unique(compute_minimizer_hashes(genome, 31, 15))
    seqs = []
    for _ in range(300):
        n = int(rng.integers(31, 3000))
        s = int(rng.integers(0, len(genome) - n))
        seqs.append(genome[s:s + n] if rng.random() < 0.5
                    else rng.choice(_B, size=n).tobytes())
    seqs[7] = genome[:300] + b"A" * 700
    pairs = list(zip(seqs[::2], seqs[1::2]))
    tiles = ((256, 64), (1024, 32))
    pipe = DevicePipeline(idx, 31, 15, tiles=tiles,
                          mesh=make_mesh(1, 4, [cuda] * 4))
    ref = DevicePipeline(idx, 31, 15, tiles=tiles, device=cuda)
    tk.probe_hits.launches = tk.select_compact.launches = 0
    got = (pipe.counts_single(seqs, 0), pipe.counts_paired(pairs, 0))
    assert tk.probe_hits.launches == 4 * tk.select_compact.launches > 0
    want = (ref.counts_single(seqs, 0), ref.counts_paired(pairs, 0))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_[0], w_[0])
        np.testing.assert_array_equal(g_[1], w_[1])
    assert pipe.rerun_units >= 1


def test_pipeline_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    genome = rng.choice(_B, size=200_000).tobytes()
    from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes

    idx = np.unique(compute_minimizer_hashes(genome, 31, 15))
    seqs = []
    for _ in range(300):
        n = int(rng.integers(31, 3000))
        s = int(rng.integers(0, len(genome) - n))
        seqs.append(genome[s:s + n] if rng.random() < 0.5
                    else rng.choice(_B, size=n).tobytes())
    # rows over their minimizer budget, rerun on the card
    seqs[7] = genome[:300] + b"A" * 700
    seqs[40] = b"CAG" * 300 + genome[900:1000]
    tiles = ((256, 64), (1024, 32))
    pipe = DevicePipeline(idx, 31, 15, tiles=tiles, device=cuda)
    got = pipe.counts_single(seqs, 0)
    want = DevicePipeline(idx, 31, 15, tiles=tiles, device="cpu").counts_single(
        seqs, 0)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    assert pipe.rerun_units >= 2


_SWITCHES = [
    ({"DEACON_TPU_TILES": "384:64,1152:32,12288:8"}, 31, "K4", None),
    ({"DEACON_ENGINE": "3"}, 31, "K4", ((256, 64), (1024, 32))),
    ({"DEACON_ENGINE": "2"}, 31, "K3", ((256, 64), (1024, 32))),
    ({"DEACON_PALLAS": "1"}, 31, "K5", ((256, 64), (1024, 32))),
    ({"DEACON_PALLAS": "1"}, 41, "K5", ((256, 64), (1024, 32))),
]


@pytest.mark.parametrize("env,k,kernel,tiles", _SWITCHES)
def test_pipeline_under_switch_on_card_matches_cpu(cuda, monkeypatch, env, k,
                                                   kernel, tiles):
    """Each switch routes the card's pipeline through its kernel, and the
    counts equal the CPU's (plain versions) under the same switch."""
    from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes

    for name, value in env.items():
        monkeypatch.setenv(name, value)
    rng = np.random.default_rng(k + 5)
    genome = rng.choice(_B, size=100_000).tobytes()
    idx = np.unique(compute_minimizer_hashes(genome, k, 15))
    seqs = []
    for _ in range(200):
        n = int(rng.integers(k, 14_000))
        s = int(rng.integers(0, len(genome) - n))
        seqs.append(genome[s:s + n] if rng.random() < 0.5
                    else rng.choice(_B, size=n).tobytes())
    seqs[5] = genome[:300] + b"A" * 700
    seqs[50] = b"CAG" * 300 + genome[900:1000]
    pipe = DevicePipeline(idx, k, 15, tiles=tiles, device=cuda)
    assert set(pipe.routes.values()) == {kernel}
    launches = {"K1": tk.select_compact, "K3": tk.values_select,
                "K4": tk.select_csum, "K5": tk.values_argmin}
    for f in launches.values():
        f.launches = 0
    got = pipe.counts_single(seqs, 0)
    want = DevicePipeline(idx, k, 15, tiles=tiles, device="cpu").counts_single(
        seqs, 0)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    assert pipe.rerun_units >= 2
    assert {n for n, f in launches.items() if f.launches} == {kernel}


def test_wide_k_pipeline_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(4)
    genome = rng.choice(_B, size=100_000).tobytes()
    from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes

    idx = np.unique(compute_minimizer_hashes(genome, 41, 15))
    seqs = []
    for _ in range(200):
        n = int(rng.integers(41, 3000))
        s = int(rng.integers(0, len(genome) - n))
        seqs.append(genome[s:s + n] if rng.random() < 0.5
                    else rng.choice(_B, size=n).tobytes())
    seqs[5] = genome[:300] + b"A" * 700
    seqs[50] = b"CAG" * 300 + genome[900:1000]
    pairs = list(zip(seqs[::2], seqs[1::2]))
    tiles = ((256, 64), (1024, 32))
    pipe = DevicePipeline(idx, 41, 15, tiles=tiles, device=cuda)
    ref = DevicePipeline(idx, 41, 15, tiles=tiles, device="cpu")
    tk.values_select.launches = 0
    for got, want in ((pipe.counts_single(seqs, 0), ref.counts_single(seqs, 0)),
                      (pipe.counts_paired(pairs, 0),
                       ref.counts_paired(pairs, 0))):
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_)
    assert pipe.rerun_units >= 2 and tk.values_select.launches > 0


@pytest.mark.parametrize("k,e", [(31, 0.0), (41, 0.5), (57, 0.0)])
def test_index_build_on_card_matches_cpu(cuda, k, e):
    from deacon_tpu_torch.ops.engine import DistinctHashes, IndexBuildPipeline

    rng = np.random.default_rng(k)
    seqs = [rng.choice(_B, size=int(n)).tobytes()
            for n in rng.integers(10, 40_000, 20)]
    seqs[3] = b"ACAC" * 600 + seqs[3]
    seqs[4] = seqs[4][:500] + b"NNRYK" * 30 + seqs[4][500:].lower()
    keys = []
    for dev in (cuda, "cpu"):
        pipe = IndexBuildPipeline(k, 15, e, device=dev)
        d = DistinctHashes(pipe.device)
        running = d.add(*pipe.extract_batch(seqs), len(seqs))
        keys.append((d.sorted_u64(), running))
    np.testing.assert_array_equal(keys[0][0], keys[1][0])
    np.testing.assert_array_equal(keys[0][1], keys[1][1])


@pytest.mark.parametrize("env,k,kernel", [({"DEACON_PALLAS": "1"}, 31, "K5"),
                                          ({"DEACON_PALLAS": "1"}, 41, "K5"),
                                          ({"DEACON_ENGINE": "3"}, 31, "K3")])
def test_index_build_under_switch_on_card_matches_cpu(cuda, monkeypatch, env,
                                                      k, kernel):
    from deacon_tpu_torch.ops.engine import DistinctHashes, IndexBuildPipeline

    for name, value in env.items():
        monkeypatch.setenv(name, value)
    rng = np.random.default_rng(k + 9)
    seqs = [rng.choice(_B, size=int(n)).tobytes()
            for n in rng.integers(10, 40_000, 12)]
    seqs[3] = b"ACAC" * 600 + seqs[3]
    keys = []
    for dev in (cuda, "cpu"):
        pipe = IndexBuildPipeline(k, 15, 0.5, device=dev)
        assert set(pipe.routes.values()) == {kernel}
        d = DistinctHashes(pipe.device)
        running = d.add(*pipe.extract_batch(seqs), len(seqs))
        keys.append((d.sorted_u64(), running))
    np.testing.assert_array_equal(keys[0][0], keys[1][0])
    np.testing.assert_array_equal(keys[0][1], keys[1][1])

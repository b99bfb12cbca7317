"""Match backends: turn per-record minimizer hash lists into keep decisions.

The decision contract matches the reference's decision kernels
(ref: src/remote_filter.rs:230-301): for each record (or pair),
return (should_keep, distinct_hit_count, total_minimizers, debug_kmers).

Backends:
* LocalBackend — membership against a local MinimizerIndex via vectorized
  sorted-array probes. The host decider (--debug, which lists each
  record's k-mers) uses it.
"""

from __future__ import annotations

import numpy as np

from ..index.store import MinimizerIndex
from ..utils import trace
from .thresholds import meets_filtering_criteria

Decision = tuple[bool, int, int, "list[str] | tuple[()]"]

#: the k-mers of every non-debug decision. One shared empty tuple, not an
#: empty list a unit: the garbage collector never untracks a list, and a
#: server with 48 requests in flight (one H100's host) spent 21-24 s of a
#: 57 s window in full collections scanning each request's 10,000 lists
NO_KMERS = ()


def _vector_decisions(batch, member_all, lengths, abs_threshold,
                      rel_threshold, deplete) -> list[Decision]:
    """Vectorized non-debug decision kernel: distinct-hit counts for the
    whole batch via one lexsort + first-occurrence scan (the per-unit
    np.unique loop costs ~60 us/unit of Python overhead — the server-side
    bottleneck once the binary wire removed JSON costs), thresholds via a
    per-unique-total memo of meets_filtering_criteria (the reference
    rounding stays in ONE place)."""
    n_units = len(batch)
    unit_of = np.repeat(
        np.arange(n_units, dtype=np.int64), lengths
    )
    midx = np.nonzero(member_all)[0]
    if midx.size:
        mh = np.concatenate([h for h, _, _ in batch])[midx]
        mu = unit_of[midx]
        order = np.lexsort((mh, mu))
        mh, mu = mh[order], mu[order]
        firsts = np.ones(mh.size, dtype=bool)
        firsts[1:] = (mh[1:] != mh[:-1]) | (mu[1:] != mu[:-1])
        hits = np.bincount(mu[firsts], minlength=n_units)
    else:
        hits = np.zeros(n_units, dtype=np.int64)
    keep_by: dict[tuple[int, int], bool] = {}
    out: list[Decision] = []
    for u in range(n_units):
        h, n = int(hits[u]), int(lengths[u])
        k = keep_by.get((h, n))
        if k is None:
            k = meets_filtering_criteria(
                h, n, abs_threshold, rel_threshold, deplete
            )
            keep_by[(h, n)] = k
        out.append((k, h, n, NO_KMERS))
    return out


class LocalBackend:
    def __init__(self, index: MinimizerIndex, probe=None):
        self.index = index
        self._probe = probe  # optional callable: uint64[n] -> bool[n]

    def probe(self, hashes: np.ndarray) -> np.ndarray:
        """Membership of ``hashes`` (span ``server.probe``, counter
        ``server.hashes``: the server's request path is the main caller)."""
        trace.count("server.hashes", hashes.size)
        with trace.span("server.probe"):
            if self._probe is not None:
                return self._probe(hashes)
            return self.index.contains(hashes)

    def decide_unpaired(
        self,
        batch: list[tuple[np.ndarray, np.ndarray, bytes]],
        kmer_length: int,
        abs_threshold: int,
        rel_threshold: float,
        deplete: bool,
        debug: bool,
    ) -> list[Decision]:
        """ref: src/remote_filter.rs:230-264 + src/filter_common.rs:129-155."""
        if not batch:
            return []
        lengths = np.array([h.size for h, _, _ in batch], dtype=np.int64)
        if lengths.sum() == 0:
            member_all = np.zeros(0, dtype=bool)
        else:
            member_all = self.probe(np.concatenate([h for h, _, _ in batch]))
        if not debug:
            return _vector_decisions(
                batch, member_all, lengths, abs_threshold, rel_threshold,
                deplete,
            )
        out: list[Decision] = []
        off = 0
        for (hashes, positions, eff_seq), n in zip(batch, lengths.tolist()):
            member = member_all[off : off + n]
            off += n
            kmers: list[str] = []
            if debug:
                seen: set[int] = set()
                for i in np.nonzero(member)[0].tolist():
                    h = int(hashes[i])
                    if h not in seen:
                        seen.add(h)
                        if i < positions.size:
                            p = int(positions[i])
                            kmers.append(
                                eff_seq[p : p + kmer_length].decode("utf-8", "replace")
                            )
                hits = len(seen)
            else:
                hits = int(np.unique(hashes[member]).size) if n else 0
            keep = meets_filtering_criteria(
                hits, n, abs_threshold, rel_threshold, deplete
            )
            out.append((keep, hits, n, kmers))
        return out

    def decide_paired(
        self,
        batch: list[tuple[np.ndarray, np.ndarray, tuple]],
        kmer_length: int,
        abs_threshold: int,
        rel_threshold: float,
        deplete: bool,
        debug: bool,
    ) -> list[Decision]:
        """ref: src/remote_filter.rs:266-301 + src/filter_common.rs:172-198.

        Note: paired debug k-mers are intentionally always empty, matching the
        reference's faithful behavior (its all_sequences vector is always empty;
        ref: src/filter_common.rs:329-344, SURVEY §7 asymmetry note).
        """
        if not batch:
            return []
        lengths = np.array([h.size for h, _, _ in batch], dtype=np.int64)
        if lengths.sum() == 0:
            member_all = np.zeros(0, dtype=bool)
        else:
            member_all = self.probe(np.concatenate([h for h, _, _ in batch]))
        return _vector_decisions(
            batch, member_all, lengths, abs_threshold, rel_threshold,
            deplete,
        )

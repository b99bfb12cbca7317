"""The index's keys, made on the device from the seed: the distinct
minimizer hashes of the host stand-in genome, topped up with seeded
random u64 values to the configuration's exact key count. Plain torch;
the program is not used."""

from __future__ import annotations

import numpy as np
import torch

from .reference import I64_MIN, minimizers

_HI = (1 << 63) - 1


def _distinct_flipped(x: torch.Tensor) -> torch.Tensor:
    """Distinct int64 keys, sign bit flipped, ascending (so ascending as
    u64 once flipped back)."""
    s = torch.sort(x ^ I64_MIN).values
    if s.numel() > 1:
        head = torch.ones(1, dtype=torch.bool, device=s.device)
        s = s[torch.cat([head, s[1:] != s[:-1]])]
    return s


def genome_hashes(genome: np.ndarray, dev, k: int, w: int) -> torch.Tensor:
    """The genome's filter-side minimizer hashes (int64, on ``dev``)."""
    starts = np.zeros(1, np.int64)
    lens = np.array([genome.size], np.int64)
    return minimizers(genome, starts, lens, dev, k, w)[1]


def make_keys(n_keys: int, host: torch.Tensor, gen: torch.Generator,
              dev) -> torch.Tensor:
    """Exactly ``n_keys`` distinct keys, the ``host`` hashes among them,
    as int64 with the sign bit flipped, ascending."""
    keys = _distinct_flipped(host)
    if keys.numel() > n_keys:
        raise ValueError(f"the host genome alone has {keys.numel()} keys, "
                         f"more than {n_keys}")
    while keys.numel() < n_keys:
        more = torch.randint(I64_MIN, _HI, (n_keys - keys.numel(),),
                             device=dev, dtype=torch.int64, generator=gen)
        keys = _distinct_flipped(torch.cat([keys ^ I64_MIN, more]))
    return keys


def to_host_u64(keys_flipped: torch.Tensor) -> np.ndarray:
    """Sorted distinct keys as the index holds them: a uint64 array."""
    return (keys_flipped ^ I64_MIN).cpu().numpy().view(np.uint64)

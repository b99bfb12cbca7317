"""Streams of random numbers derived from a run's ``--seed`` and a tag,
so that each input (genome, keys, pool) has its own stream and the same
seed always gives the same inputs. Any whole number is a seed."""

from __future__ import annotations

import zlib

import numpy as np
import torch


def _state(seed: int, tags) -> np.random.SeedSequence:
    words = [int(seed) % (1 << 64)] + [zlib.crc32(str(t).encode())
                                        for t in tags]
    return np.random.SeedSequence(words)


def rng(seed: int, *tags) -> np.random.Generator:
    """A NumPy generator for ``seed`` and ``tags``."""
    return np.random.default_rng(_state(seed, tags))


def generator(seed: int, tag: str, device) -> torch.Generator:
    """A torch generator on ``device`` for ``seed`` and ``tag``."""
    value = int(_state(seed, [tag]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(value >> 1)

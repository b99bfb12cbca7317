"""FilterConfig and IndexConfig: the fields ``filter`` and ``index build``
read (ref: src/lib.rs:39-109, 187-226)."""

from __future__ import annotations

from dataclasses import dataclass

from .constants import (
    DEFAULT_ABS_THRESHOLD,
    DEFAULT_CAPACITY_MILLIONS,
    DEFAULT_COMPRESSION_LEVEL,
    DEFAULT_KMER_LENGTH,
    DEFAULT_REL_THRESHOLD,
    DEFAULT_WINDOW_SIZE,
    FILTER_BATCH,
)


@dataclass
class FilterConfig:
    """ref: src/lib.rs:39-109 (defaults from FilterConfig::new)."""

    minimizers_path: str
    input_path: str = "-"
    input2_path: str | None = None
    output_path: str = "-"
    output2_path: str | None = None
    abs_threshold: int = DEFAULT_ABS_THRESHOLD
    rel_threshold: float = DEFAULT_REL_THRESHOLD
    prefix_length: int = 0
    summary_path: str | None = None
    deplete: bool = False
    rename: bool = False
    threads: int = 0
    compression_level: int = DEFAULT_COMPRESSION_LEVEL
    debug: bool = False
    quiet: bool = False
    #: "cuda" (the default) or "cpu"; see device.resolve_device
    device: str = "cuda"
    batch_size: int = FILTER_BATCH

    def execute(self) -> None:
        from .filter.engine import run

        run(self)


@dataclass
class IndexConfig:
    """ref: src/lib.rs:187-226."""

    input_path: str = "-"
    kmer_length: int = DEFAULT_KMER_LENGTH
    window_size: int = DEFAULT_WINDOW_SIZE
    #: None or "-" writes the index to stdout
    output_path: str | None = None
    capacity_millions: int = DEFAULT_CAPACITY_MILLIONS
    threads: int = 8
    quiet: bool = False
    entropy_threshold: float = 0.0
    #: "cuda" (the default) or "cpu"; see device.resolve_device
    device: str = "cuda"

    def execute(self) -> None:
        from .index.build import build

        build(self)

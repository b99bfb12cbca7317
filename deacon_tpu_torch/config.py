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

    minimizers_path: str | None = None
    #: a server's address (``client``): decisions on the server's index
    server_address: str | None = None
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
    #: "cuda" (the default), "cpu" (device.resolve_device), or "host": the
    #: host library's whole pipeline (filter.engine.run_host_pipeline)
    device: str = "cuda"
    batch_size: int = FILTER_BATCH
    #: device mesh "DATAxSHARD" (e.g. "2x4"): read batches data-parallel
    #: over DATA rows, the index's radix table cut over SHARD devices
    #: (filter.engine.filter_mesh); or a multi-process mode, "pod",
    #: "pod-data" or "pod-2d" (parallel/multihost.py)
    mesh: str | None = None

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
    #: "cuda" (the default), "cpu" (device.resolve_device), or "host":
    #: extraction in the host library (index.build's host route)
    device: str = "cuda"
    #: "pod-data": every rank (DEACON_NUM_PROC, DEACON_PROC_ID) indexes its
    #: own byte range and rank 0 merges the parts (index/pod_build.py)
    mesh: str | None = None

    def execute(self) -> None:
        from .index.build import build

        build(self)

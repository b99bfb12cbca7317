"""deacon-tpu-torch: the PyTorch/CUDA port of the deacon-tpu read filter.

A package of its own beside ``deacon_tpu``: it imports ``torch`` and
``numpy`` and nothing of the JAX package. ``index build`` and ``filter``
run on an NVIDIA card (device "cuda", the default) with three
hand-written CUDA kernels (csrc/extract.cu, csrc/values_select.cu,
csrc/radix_probe.cu), or on the CPU with their plain PyTorch versions
when the caller passes device "cpu".
"""

from .constants import VERSION
from .index.store import IndexHeader, MinimizerIndex, load_index, write_index
from .ops.minimizers_np import (
    compute_minimizer_hashes,
    get_minimizer_hashes_and_positions,
)

__version__ = VERSION

__all__ = [
    "VERSION",
    "IndexHeader",
    "MinimizerIndex",
    "load_index",
    "write_index",
    "compute_minimizer_hashes",
    "get_minimizer_hashes_and_positions",
]

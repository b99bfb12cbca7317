"""Global constants of the PyTorch port (reference defaults:
src/minimizers.rs:4-5, src/lib.rs:89-109)."""

VERSION = "0.1.0"
TOOL_NAME = "deacon-tpu-torch"

# Minimizer scheme defaults (ref: src/minimizers.rs:4-5)
DEFAULT_KMER_LENGTH = 31
DEFAULT_WINDOW_SIZE = 15

# Index container (ref: src/index.rs:17-31)
INDEX_FORMAT_VERSION = 2

# k-mer length limits: filtering needs the invalid-base bitmask (k <= 56,
# ref: src/filter_common.rs:230); index build accepts 1..=57
# (ref: src/main.rs:166) and diff-vs-FASTX 1..=32 by -k
# (ref: src/main.rs:223)
MAX_K_FILTER = 56
MAX_K_BUILD = 57
MAX_K_DIFF_FASTX = 32

# Filtering defaults (ref: src/lib.rs:89-109)
DEFAULT_ABS_THRESHOLD = 2
DEFAULT_REL_THRESHOLD = 0.01
DEFAULT_COMPRESSION_LEVEL = 2

# Records per decision batch (ref: src/remote_filter.rs:727)
FILTER_BATCH = 10_000

# Records per index-build batch
INDEX_BUILD_BATCH = 10_000

# Records per batch of ``index diff`` against a FASTX stream
DIFF_STREAM_BATCH = 1_000

# Preallocated capacity (millions of minimizers) reported by index build
DEFAULT_CAPACITY_MILLIONS = 400

"""Multi-device filter: a mesh of torch devices (parallel/sharded.py)."""

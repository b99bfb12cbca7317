"""One run of one cell, found by name in BENCHMARK.json.

Everything that belongs to one configuration, one traffic mix or one
metric lives in files of its own, found by name:

- a configuration: the ``file`` its entry in BENCHMARK.json names
  (``benchmark/configs/<name>.json``);
- a traffic mix: ``benchmark/traffic/<traffic>.json``, which names its
  generator (``benchmark/generators/<generator>.py``) and its driver
  (``benchmark/drivers/<driver>.py``: set-up, window, reference and
  comparison, returning the context the metric readers read);
- a metric: ``benchmark/metrics/<name>.py``, whose ``read(ctx)`` returns
  the value, or None when it finds nothing to read (the metric is then
  left out of the result).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = __package__ or "benchmark"


def load_manifest(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_entry(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_data(bench: dict, root: str, cell: dict) -> dict:
    for c in bench["configs"]:
        if c["name"] == cell["config"]:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration {cell['config']!r} in BENCHMARK.json")


def traffic_data(root: str, traffic: str) -> dict:
    path = os.path.join(root, os.path.basename(HERE), "traffic",
                        f"{traffic}.json")
    with open(path) as f:
        return json.load(f)


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace off) or per-layer ones: those
    that list the cell, or list no cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The module ``benchmark/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_name = f"{PACKAGE}.metrics.m_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def device_info(ctx: dict, trace: bool) -> dict:
    import torch

    dev = ctx["device"]
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1,
                "memory_peak_bytes": ctx.get("program_peak_bytes", 0)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    t = ctx.get("trace")
    if trace and t is not None:
        info["busy_s"] = t["busy_s"]
        info["window_s"] = t["slice_s"]
    if ctx.get("card"):
        info["card"] = ctx["card"]
    return info


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, log) -> dict:
    """Run cell ``name`` once; returns the result line as a dict, with
    ``checks`` (each number compared, with its limit) as its last key."""
    bench = load_manifest(root)
    cell = cell_entry(bench, name)
    config = config_data(bench, root, cell)
    traffic = traffic_data(root, cell["traffic"])
    driver = importlib.import_module(f"{PACKAGE}.drivers.{traffic['driver']}")
    ctx = driver.run(config, traffic, seed, seconds, trace, device, t_start,
                     log)
    metrics = {}
    for m in metrics_of(bench, name, trace):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = ctx["checks"]
    failed = sum(int(c["value"]) for c in checks.values())
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": int(ctx["units"]), "failed": failed,
        "metrics": metrics, "device": device_info(ctx, trace)}
    if trace and ctx.get("trace") is not None:
        from .devtrace import breakdown

        result["breakdown"] = breakdown(ctx["trace"])
    result["checks"] = checks
    for key in ("start_s", "keys_s", "keys_peak_bytes", "pool_s",
                "table_build_s", "warm_s", "setup_s", "window_s",
                "repetitions", "reference_s"):
        if key in ctx:
            log(f"{key}={ctx[key]}")
    log(f"counters={json.dumps(ctx.get('counters', {}))}")
    return result


FORBIDDEN = ("jax", "jaxlib", "flax", "deacon_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``deacon_tpu_torch`` is not
    ``deacon_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_lines(checks: dict) -> list:
    return [f"check {n}: {c['value']} (limit {c['limit']})"
            for n, c in checks.items()]


def cache_dirs(root: str) -> None:
    """Build and kernel caches inside the checkout, at fixed paths."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)

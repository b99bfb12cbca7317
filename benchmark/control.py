"""The control of ``correct``: the reference put in the program's place
with one of the configuration's guarantees broken, which the comparison
has to refuse.

The configuration states exact membership: hits count the unit's
minimizer hashes that the index holds, with no false positives. The
control probes with 32-bit fingerprints instead (the top half of each
64-bit hash against the top halves of the keys), the step that a smaller
table would tempt a later change to take. Its answers go through the
same comparison as the program's: every unit's hits, totals and keep,
and the records that its keep decisions would write.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

prints, for each seed, the compared numbers of the control beside their
limits, and the exact reference's, one JSON line a seed. It runs the
reference alone, on the device, at the cell's own size; the program is
not imported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

if __name__ == "__main__":
    # the checkout's root, not this directory, heads the import path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402
from benchmark.generators.reads import random_bases  # noqa: E402
from benchmark.index_keys import genome_hashes, make_keys  # noqa: E402
from benchmark.reference import (  # noqa: E402
    I64_MIN,
    keep_mask,
    member_exact,
    unit_counts,
)
from benchmark.seeds import generator, rng  # noqa: E402

FINGERPRINT_BITS = 32


def member_fingerprint(keys_flipped: torch.Tensor,
                       h: torch.Tensor) -> torch.Tensor:
    """Membership by the top FINGERPRINT_BITS of each hash alone. The
    flipped keys' top bits ascend with them, so a searchsorted over the
    keys' fingerprints finds any key that shares one."""
    shift = 64 - FINGERPRINT_BITS
    fp = keys_flipped >> shift
    q = (h ^ I64_MIN) >> shift
    i = torch.searchsorted(fp, q).clamp(max=fp.numel() - 1)
    return fp[i] == q


def checks_of(pool, hits, totals, keep, ref) -> dict:
    """The driver's comparison of answers to the pool once over against the
    reference's (``ref``: hits, totals, keep)."""
    from benchmark.drivers.filter_stream import compare

    kept = np.nonzero(keep)[0]
    outputs = []
    for f in pool.files:
        data = f.records(kept).tobytes()
        outputs.append({"head": [data], "bytes": len(data)})
    one_pass = {"units": pool.n_units, "hits": hits, "totals": totals,
                "keep": keep, "outputs": outputs}
    return compare(pool, one_pass, *ref, gz=False)


def run_control(config: dict, traffic: dict, seed: int, device: str) -> dict:
    """The inputs of ``seed`` as the driver makes them, the exact
    reference and the control; the control's compared numbers and the
    exact reference's (against itself)."""
    import importlib

    dev = torch.device(device)
    k, w = int(config["k"]), int(config["w"])
    genome = random_bases(rng(seed, "genome", config["host_genome_salt"]),
                          int(config["host_genome_bp"]))
    keys = make_keys(int(config["n_keys"]), genome_hashes(genome, dev, k, w),
                     generator(seed, "keys", dev), dev)
    gen_mod = importlib.import_module(
        f"benchmark.generators.{traffic['generator']}")
    pool = gen_mod.make_pool(traffic["pool"], genome,
                             rng(seed, "pool", traffic["generator"]))
    rule = (int(config["abs_threshold"]), float(config["rel_threshold"]),
            bool(traffic.get("deplete", config["deplete"])))
    out = {}
    ref = None
    for name, member in (("reference", member_exact),
                         ("control", member_fingerprint)):
        hits, totals = unit_counts(pool.arena, pool.starts, pool.lens,
                                   pool.unit_of_seq, pool.n_units, keys, dev,
                                   k, w, member=member)
        keep = keep_mask(hits, totals, *rule)
        if ref is None:
            ref = (hits, totals, keep)
        out[name] = checks_of(pool, hits, totals, keep, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    root = os.getcwd()
    bench = harness.load_manifest(root)
    cell = harness.cell_entry(bench, args.workload)
    config = harness.config_data(bench, root, cell)
    traffic = harness.traffic_data(root, cell["traffic"])
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = run_control(config, traffic, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t, **out}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

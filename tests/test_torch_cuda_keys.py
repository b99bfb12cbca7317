"""The server's probe and index diff's key set on the card against the
CPU: ``DeviceHashProbe`` called from several threads at once, and
``KeptKeys`` after a batch extracted by K1, K3 and K5 (the running
removed counts per record too).

Marked ``cuda``: each test asks a fixture whether a card is present and
skips without one (the decision is never taken at import or collection,
so every pytest-xdist worker collects the same tests). On a machine with
an H100: ``python -m pytest tests/test_torch_cuda_keys.py -m cuda
--noconftest``.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

_B = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_hash_probe_on_card_matches_cpu(cuda):
    """The server's probe: keys resident on the card, calls from several
    threads at once, against the CPU probe (edge values and the empty
    batch too)."""
    import concurrent.futures

    from deacon_tpu_torch.ops.engine import DeviceHashProbe

    rng = np.random.default_rng(13)
    keys = np.unique(np.concatenate([
        rng.integers(0, 2**64, 200_000, dtype=np.uint64),
        np.array([0, 2**63, 2**64 - 1], np.uint64)]))
    on_card, on_cpu = DeviceHashProbe(keys, cuda), DeviceHashProbe(keys, "cpu")
    qs = [np.concatenate([keys[rng.integers(0, keys.size, n)],
                          rng.integers(0, 2**64, n, dtype=np.uint64),
                          np.array([0, 1, 2**63 - 1, 2**64 - 1], np.uint64)])
          for n in (1, 1000, 50_000) for _ in range(8)]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        got = list(pool.map(on_card, qs))
    for q, g in zip(qs, got):
        np.testing.assert_array_equal(g, on_cpu(q))
    assert on_card(np.zeros(0, np.uint64)).shape == (0,)


@pytest.mark.parametrize("env,k,kernel", [({}, 31, "K1"), ({}, 41, "K3"),
                                          ({"DEACON_PALLAS": "1"}, 41, "K5")])
def test_diff_key_set_on_card_matches_cpu(cuda, monkeypatch, env, k, kernel):
    """index diff's FASTX part: the first index's keys less a batch's
    minimizers, with the running removed counts per record."""
    from deacon_tpu_torch.ops.engine import IndexBuildPipeline, KeptKeys
    from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes

    for name, value in env.items():
        monkeypatch.setenv(name, value)
    rng = np.random.default_rng(k + 21)
    seqs = [rng.choice(_B, size=int(n)).tobytes()
            for n in rng.integers(10, 30_000, 12)]
    keys = np.unique(np.concatenate(
        [compute_minimizer_hashes(s, k, 15) for s in seqs[::2]]
        + [rng.integers(0, 2**64, 50_000, dtype=np.uint64)]))
    out = []
    for dev in (cuda, "cpu"):
        pipe = IndexBuildPipeline(k, 15, device=dev)
        assert set(pipe.routes.values()) == {kernel}
        kept = KeptKeys(keys, pipe.device)
        running = kept.remove(*pipe.extract_batch(seqs), len(seqs))
        out.append((kept.remaining(), running))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert 0 < out[0][0].size < keys.size

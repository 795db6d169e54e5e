"""The port's hot-row caches held against the reference's.

The same key streams (the reference's Zipf streams,
``tests/test_serve_path.py:161``, with seeds parametrized) drive the JAX
package's ``HotRowCache`` / ``DeviceHotRowCache`` and the port's (slabs on
the CPU).  Event logs, ``stats.as_dict()``, admitted keys and slot ids must
be equal, not close: the policy is deterministic, and the port picks its
victims off a heap where the reference scans.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import cache as jcache
from repro_torch.serve.cache import CachePinned, DeviceHotRowCache, HotRowCache, RowRef

SEEDS = (0, 3, 17, 2024)


def _zipf_stream(seed, n, universe=40):
    rng = np.random.default_rng(seed)
    return [int(k) % universe for k in rng.zipf(1.3, size=n)]


def _pair(kind, **kw):
    """(reference cache, port cache) of one class and configuration."""
    if kind == "host":
        return jcache.HotRowCache(**kw), HotRowCache(**kw)
    return jcache.DeviceHotRowCache(**kw), DeviceHotRowCache(device="cpu", **kw)


@pytest.mark.parametrize("kind", ["host", "device"])
@pytest.mark.parametrize("policy", ["lru", "lfu"])
@pytest.mark.parametrize("cap", [1, 2, 5, 12])
@pytest.mark.parametrize("seed", SEEDS)
def test_replay_matches_reference(kind, policy, cap, seed):
    """``replay`` logs and stats equal the reference's, and a second replay
    on a fresh port cache repeats the first bit for bit."""
    stream = _zipf_stream(seed, 100)
    ref, port = _pair(kind, capacity_rows=cap, policy=policy)
    want = ref.replay(stream, row_bytes=32)
    assert port.replay(stream, row_bytes=32) == want
    assert port.stats.as_dict() == ref.stats.as_dict()
    again = DeviceHotRowCache(capacity_rows=cap, policy=policy, device="cpu")
    assert again.replay(stream, row_bytes=32) == want


@pytest.mark.parametrize("policy", ["lru", "lfu"])
@pytest.mark.parametrize("cap", [1, 4, 12])
@pytest.mark.parametrize("seed", SEEDS)
def test_capacity_and_conservation_match_reference(policy, cap, seed):
    """Row capacity never exceeded; insertions − evictions − invalidations
    equals the resident count; every resident row reads back as the exact
    value admitted; the event log is the reference's."""
    ref, port = _pair("device", capacity_rows=cap, policy=policy, record_events=True)
    for k in _zipf_stream(seed, 150):
        for c in (ref, port):
            if c.get(k) is None:
                c.put(k, np.full(8, float(k) + 0.5, np.float32))
        assert len(port) <= cap
    s = port.stats
    assert s.insertions - s.evictions - s.invalidations == len(port)
    assert s.hits + s.misses == 150
    assert port.events == ref.events and s.as_dict() == ref.stats.as_dict()
    for k in list(port._rows):
        np.testing.assert_array_equal(port.get(k), np.full(8, float(k) + 0.5, np.float32))


@pytest.mark.parametrize("policy", ["lru", "lfu"])
@pytest.mark.parametrize("cap_bytes", [64, 200, 600])
@pytest.mark.parametrize("seed", SEEDS)
def test_byte_budget_mixed_widths_match_reference(policy, cap_bytes, seed):
    """Byte budget never exceeded with mixed-width rows; oversized rows
    reject instead of flushing; the same events as the reference."""
    ref, port = _pair("device", capacity_rows=None, capacity_bytes=cap_bytes,
                      policy=policy, record_events=True)
    for k in _zipf_stream(seed, 120):
        width = 4 * (1 + k % 4)            # 4/8/12/16 f32 → 16..64 bytes
        for c in (ref, port):
            if c.get(k) is None:
                c.put(k, np.full(width, float(k), np.float32))
        assert port.stats.bytes_cached <= cap_bytes
    assert port.stats.bytes_cached == sum(r.nbytes for r in port._rows.values())
    assert port.events == ref.events and port.stats.as_dict() == ref.stats.as_dict()
    for k in list(port._rows):
        np.testing.assert_array_equal(port.get(k), np.asarray(ref.get(k)))


@pytest.mark.parametrize("policy", ["lru", "lfu"])
@pytest.mark.parametrize("cap", [3, 16, 64])
@pytest.mark.parametrize("seed", SEEDS)
def test_engine_waves_match_reference(policy, cap, seed):
    """The engine's batched protocol, wave after wave: ``lookup_many`` with
    ``np.unique`` counts, then ``put_many`` of the misses with the whole
    wave pinned.  Slots, miss masks, admitted keys, events, stats and the
    slab rows equal the reference's, including waves whose admission is
    refused because the wave cannot be pinned."""
    rng = np.random.default_rng(seed)
    ref, port = _pair("device", capacity_rows=cap, policy=policy, record_events=True)
    for _ in range(12):
        keys = np.asarray(_zipf_stream(int(rng.integers(1 << 30)), int(rng.integers(1, 40)),
                                       universe=200), np.int64)
        uniq, counts = np.unique(keys, return_counts=True)
        key_list = uniq.tolist()
        (rs, rm), (ps, pm) = (c.lookup_many(key_list, counts) for c in (ref, port))
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_array_equal(pm, rm)
        if not pm.any():
            continue
        miss = uniq[pm].tolist()
        rows = np.stack([np.full(4, k + 0.25, np.float32) for k in miss])
        block = torch.from_numpy(np.concatenate([rows, rows[:1]]))   # one spare row
        want = ref.put_many(miss, jnp.asarray(rows), pinned=key_list)
        got = port.put_many(miss, [RowRef(block, j) for j in range(len(miss))],
                            pinned=key_list)
        assert got == want
        if len(got) == len(miss):
            np.testing.assert_array_equal(port.slots_for(miss), ref.slots_for(miss))
    assert port.events == ref.events and port.stats.as_dict() == ref.stats.as_dict()
    pk, ps = port.slot_items()
    rk, rs = ref.slot_items()
    np.testing.assert_array_equal(pk, rk)
    np.testing.assert_array_equal(ps, rs)
    for k in pk.tolist():
        np.testing.assert_array_equal(port.get(k), np.full(4, k + 0.25, np.float32))


def test_pinning_blocks_eviction():
    """``put_many`` never evicts a pinned key: admission is rejected instead
    (the engine's same-wave slot-integrity guarantee)."""
    c = DeviceHotRowCache(capacity_rows=2, device="cpu")
    c.put_many([1, 2], np.ones((2, 4), np.float32))
    admitted = c.put_many([3], np.zeros((1, 4), np.float32), pinned=[1, 2])
    assert admitted == [] and c.stats.rejections == 1
    assert sorted(c._rows) == [1, 2]
    with pytest.raises(CachePinned):
        c._pinned = {1, 2}
        try:
            c._victim()
        finally:
            c._pinned = set()
    # unpinned, the same admission lands and evicts per policy
    assert c.put_many([3], np.zeros((1, 4), np.float32)) == [3]
    assert c.stats.evictions == 1


def test_scatter_dedupes_reused_slot():
    """A slot freed by an eviction and reused in the same ``put_many`` must
    land the *newer* row (last-write-wins in the batched write)."""
    c = DeviceHotRowCache(capacity_rows=1, device="cpu")
    rows = np.stack([np.full(4, 1.0, np.float32), np.full(4, 2.0, np.float32)])
    c.put_many([10, 11], rows)          # 10 admitted then evicted for 11
    assert list(c._rows) == [11]
    np.testing.assert_array_equal(c.get(11), rows[1])


def test_lookup_many_counts_occurrences():
    c = DeviceHotRowCache(capacity_rows=8, device="cpu")
    c.put(5, np.ones(4, np.float32))
    slots, miss = c.lookup_many([5, 6], counts=np.array([3, 2]))
    assert slots[0] >= 0 and slots[1] == -1
    assert (miss == [False, True]).all()
    assert c.stats.hits == 3 and c.stats.misses == 2


def test_invalidate_all_releases_slabs_and_moves_the_version():
    ref, port = _pair("device", capacity_rows=8, record_events=True)
    for c in (ref, port):
        c.put_many([1, 2, 3], np.ones((3, 4), np.float32))
    v = port.residency_version
    assert port.invalidate_all() == ref.invalidate_all() == 3
    assert port.residency_version == ref.residency_version > v
    assert port.stats.as_dict() == ref.stats.as_dict() and port.events == ref.events
    assert not port._slabs and len(port) == 0
    assert port.replay([1, 2, 1], row_bytes=16) == ref.replay([1, 2, 1], row_bytes=16)


def test_slab_is_preallocated_and_written_under_inference_mode():
    """A slab made inside ``torch.inference_mode`` (the engine's dispatch)
    takes writes from outside it, and one made outside takes writes from
    inside: every slab is allocated and written in inference mode."""
    c = DeviceHotRowCache(capacity_rows=100, device="cpu")
    with torch.inference_mode():
        assert c.slab(4).shape == (100, 4)
    c.put(1, np.full(4, 3.0, np.float32))
    np.testing.assert_array_equal(c.get(1), np.full(4, 3.0, np.float32))
    d = DeviceHotRowCache(capacity_rows=100, device="cpu")
    d.put(1, np.full(4, 1.0, np.float32))
    with torch.inference_mode():
        d.put_many([2], torch.full((1, 4), 2.0))
    np.testing.assert_array_equal(d.get(2), np.full(4, 2.0, np.float32))
    big = DeviceHotRowCache(capacity_rows=(1 << 20) + 1, device="cpu")
    assert big.slab(2).shape == (64, 2)      # above the preallocation cap: grows


def test_rejects_bad_configuration():
    with pytest.raises(ValueError, match="policy"):
        HotRowCache(policy="fifo")
    with pytest.raises(ValueError, match="capacity"):
        DeviceHotRowCache(capacity_rows=None, device="cpu")
    with pytest.raises(ValueError, match="capacity_rows"):
        DeviceHotRowCache(capacity_rows=0, device="cpu")

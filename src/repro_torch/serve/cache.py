"""Hot-row embedding cache for the recsys serving path.

Zipfian category traffic (the reason the paper's thresholding works) means
a tiny fraction of (quotient, remainder) pairs absorbs most lookups.  The
cache keeps the *combined, dequantized* f32 rows for those pairs: a hit
skips both int8 gathers and the dequant+combine entirely; a miss is
computed once (by the engine) and admitted.

Keys are ``(table, quotient, remainder)`` triples or the engine's packed
int64 keys — one keyspace covers full / hash / QR tables.

Design constraints (all pinned by tests against the JAX package's cache):

* **deterministic** — recency/admission use a logical op clock, never wall
  time, and every tie (equal LFU frequency) breaks by least-recent-use,
  then insertion order.  Replaying a key stream on a fresh cache
  reproduces the exact hit/miss/evict event sequence (``replay``).
* **accounted** — hits, misses, evictions, insertions, rejections,
  invalidations and resident bytes are counters (``CacheStats``).
* **bounded** — ``capacity_rows`` rows max, and/or ``capacity_bytes``
  resident bytes max (cached rows are combined f32, 4·D bytes each);
  admission beyond either bound evicts per ``policy`` ("lru" or "lfu").
  A row bigger than the whole byte budget is *rejected* (counted in
  ``stats.rejections``); if that key was resident, the stale value is
  dropped as an ``invalidate`` event, never counted as an eviction.

The victim is the policy's minimum over the resident, unpinned keys, as
in the reference; it is read off a lazily pruned heap instead of a scan,
so a full cache admits a row in O(log n) (a wave at full width admits
thousands).  A use only marks its key; marked keys join the heap at
their new rank when a victim is next needed, so the hit path allocates
nothing.  A heap entry is live while its key is resident with the same
rank; pinned keys popped while looking for a victim wait aside until the
pins change.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Hashable, Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

__all__ = ["CacheStats", "HotRowCache", "DeviceHotRowCache", "CachePinned", "RowRef"]

POLICIES = ("lru", "lfu")


class CachePinned(Exception):
    """Admission needs an eviction but every resident row is pinned (the
    engine pins this wave's hit rows so an in-flight device gather never
    reads a reassigned slot).  The caller skips the admission."""


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0             # capacity-pressure removals only
    insertions: int = 0
    rejections: int = 0            # rows larger than the whole byte budget
    # resident rows dropped by a rejected refresh (not capacity pressure)
    invalidations: int = 0
    bytes_cached: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "insertions": self.insertions,
                "rejections": self.rejections,
                "invalidations": self.invalidations,
                "bytes_cached": self.bytes_cached,
                "lookups": self.lookups, "hit_rate": self.hit_rate}


class HotRowCache:
    def __init__(self, capacity_rows: Optional[int] = 4096,
                 policy: str = "lfu", record_events: bool = False,
                 capacity_bytes: Optional[int] = None):
        if policy not in POLICIES:
            raise ValueError(f"policy={policy!r} not in {POLICIES}")
        if capacity_rows is None and capacity_bytes is None:
            raise ValueError("need capacity_rows and/or capacity_bytes")
        if capacity_rows is not None and capacity_rows < 1:
            raise ValueError("capacity_rows must be >= 1 (or None)")
        if capacity_bytes is not None and capacity_bytes < 1:
            raise ValueError("capacity_bytes must be >= 1 (or None)")
        self.capacity_rows = capacity_rows
        self.capacity_bytes = capacity_bytes
        self.policy = policy
        self.stats = CacheStats()
        self.record_events = record_events
        self.events: list[tuple[str, Hashable]] = []
        self._rows: dict[Hashable, object] = {}   # key -> stored entry
        self._freq: dict[Hashable, int] = {}
        self._used: dict[Hashable, int] = {}      # logical clock of last use
        self._inserted: dict[Hashable, int] = {}  # admission order
        self._heap: list = []                     # (rank, key), lazily pruned
        self._moved: set = set()                  # keys re-ranked since the last sync
        self._held: list = []                     # pinned entries popped by _victim
        self._pins: set = set()                   # exempt from eviction
        self._clock = 0
        self._admissions = 0

    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, key) -> bool:
        return key in self._rows

    def _event(self, kind: str, key) -> None:
        if self.record_events:
            self.events.append((kind, key))

    # ---- victim order: the policy's rank, kept on a heap
    @property
    def _pinned(self) -> set:
        return self._pins

    @_pinned.setter
    def _pinned(self, keys) -> None:
        self._pins = set(keys)
        for entry in self._held:          # pins changed: held entries compete again
            heapq.heappush(self._heap, entry)
        self._held = []

    def _rank(self, key) -> tuple:
        if self.policy == "lru":
            return (self._used[key],)
        # lfu: least frequency, ties by least recent use, then admission order
        return (self._freq[key], self._used[key], self._inserted[key])

    def _touch(self, key) -> None:
        """Mark ``key``'s rank as changed (its heap entry goes stale)."""
        self._moved.add(key)

    def _sync_heap(self) -> None:
        """Queue every marked key that is still resident at its new rank,
        or rebuild the heap when stale entries outnumber live ones."""
        rows = self._rows
        if len(self._heap) + len(self._moved) > 2 * len(rows) + 1024 and not self._held:
            self._heap = [(self._rank(k), k) for k in rows]
            heapq.heapify(self._heap)
        else:
            for key in self._moved:
                if key in rows:
                    heapq.heappush(self._heap, (self._rank(key), key))
        self._moved.clear()

    # ---- storage hooks: the only seams DeviceHotRowCache overrides, so
    # ---- policy/accounting/event semantics are shared
    def _coerce(self, row):
        """Normalize an incoming row; ``.nbytes`` of the result is what the
        byte budget charges."""
        return np.asarray(row)

    def _store(self, key, row) -> None:
        """Bind ``row`` (already coerced) to ``key`` — insert or refresh."""
        self._rows[key] = row

    def _release(self, key) -> None:
        """Storage-side teardown before ``key``'s bookkeeping is dropped."""

    def _fetch(self, key):
        """Materialize the stored row for a host-side ``get``."""
        return self._rows[key]

    def get(self, key) -> Optional[np.ndarray]:
        """Row for ``key`` or None; counts the hit/miss and bumps recency."""
        self._clock += 1
        if key not in self._rows:
            self.stats.misses += 1
            self._event("miss", key)
            return None
        self.stats.hits += 1
        self._freq[key] += 1
        self._used[key] = self._clock
        self._touch(key)
        self._event("hit", key)
        return self._fetch(key)

    def _victim(self, exclude: Hashable = None) -> Hashable:
        self._sync_heap()
        heap, skipped = self._heap, []
        try:
            while heap:
                rank, key = heap[0]
                if key not in self._rows or self._rank(key) != rank:
                    heapq.heappop(heap)                      # stale entry
                elif key in self._pins:
                    self._held.append(heapq.heappop(heap))
                elif key == exclude:
                    skipped.append(heapq.heappop(heap))
                else:
                    return key
        finally:
            for entry in skipped:
                heapq.heappush(heap, entry)
        raise CachePinned(f"{len(self._pins)} pinned, no victim")

    def _remove(self, key: Hashable, kind: str = "evict") -> None:
        """Drop ``key`` with full bookkeeping.  ``kind="evict"`` is a
        capacity-pressure removal (counted in ``stats.evictions``);
        ``kind="invalidate"`` is a rejection- or swap-driven removal of a
        stale resident value (counted in ``stats.invalidations``)."""
        self.stats.bytes_cached -= self._rows[key].nbytes
        self._release(key)
        del self._rows[key], self._freq[key]
        del self._used[key], self._inserted[key]
        if kind == "evict":
            self.stats.evictions += 1
        else:
            self.stats.invalidations += 1
        self._event(kind, key)

    def _evict_one(self, exclude: Hashable = None) -> None:
        self._remove(self._victim(exclude))

    def _over_bytes(self, incoming: int) -> bool:
        return (self.capacity_bytes is not None
                and self.stats.bytes_cached + incoming > self.capacity_bytes)

    def put(self, key, row) -> None:
        """Admit ``row`` under ``key``, evicting per policy when full —
        by row count and/or resident bytes, whichever binds first."""
        row = self._coerce(row)
        if self.capacity_bytes is not None and row.nbytes > self.capacity_bytes:
            # inadmissible: even an empty cache couldn't hold it
            self.stats.rejections += 1
            self._event("reject", key)
            if key in self._rows:  # the stale smaller value must not linger
                self._remove(key, kind="invalidate")
            return
        if key in self._rows:  # refresh in place (value update, not a use)
            self.stats.bytes_cached += row.nbytes - self._rows[key].nbytes
            self._store(key, row)
            # a grown refresh can push past the budget: shed other rows
            while self._over_bytes(0) and len(self._rows) > 1:
                self._evict_one(exclude=key)
            return
        while (self.capacity_rows is not None
               and len(self._rows) >= self.capacity_rows):
            self._evict_one()
        while self._over_bytes(row.nbytes) and self._rows:
            self._evict_one()
        self._clock += 1
        self._admissions += 1
        self._store(key, row)
        self._freq[key] = 1
        self._used[key] = self._clock
        self._inserted[key] = self._admissions
        self._touch(key)
        self.stats.insertions += 1
        self.stats.bytes_cached += row.nbytes
        self._event("put", key)

    def invalidate_all(self) -> int:
        """Drop every resident row, counted as *invalidations* (the rows
        are stale: ``RecsysEngine.swap_plan`` installs a new plan whose
        combined rows the old residency no longer matches).  Returns the
        number of rows dropped; eviction counters are untouched."""
        keys = list(self._rows)
        for key in keys:
            self._remove(key, kind="invalidate")
        self._heap, self._held = [], []
        self._moved.clear()
        return len(keys)

    def get_many(self, keys: Iterable[Hashable]):
        """Batched get: ``(found: {key: row}, missing: [unique keys])``.

        ``missing`` preserves first-appearance order so the caller's
        fill-compute (and therefore admission order) is deterministic.
        """
        found: dict[Hashable, np.ndarray] = {}
        missing: list[Hashable] = []
        seen_missing = set()
        for key in keys:
            if key in found:
                # repeated key in one batch: count the extra hit, bump freq
                self._clock += 1
                self.stats.hits += 1
                self._freq[key] += 1
                self._used[key] = self._clock
                self._touch(key)
                self._event("hit", key)
                continue
            row = self.get(key)
            if row is not None:
                found[key] = row
            elif key not in seen_missing:
                seen_missing.add(key)
                missing.append(key)
        return found, missing

    def replay(self, keys: Iterable[Hashable], row_bytes: int = 0
               ) -> list[tuple[str, Hashable]]:
        """Deterministic replay mode (tests): drive a raw key stream through
        the full get→miss→put cycle with placeholder rows and return the
        event log."""
        was_recording, self.record_events = self.record_events, True
        start = len(self.events)
        placeholder = np.zeros((max(row_bytes, 4) // 4,), np.float32)
        for key in keys:
            if self.get(key) is None:
                self.put(key, placeholder)
        self.record_events = was_recording
        return self.events[start:]


# --------------------------------------------------------------------------
# device-resident storage


@dataclasses.dataclass
class _Slot:
    """Bookkeeping record for one cached row living in a device slab.
    ``nbytes`` mirrors the array attribute so the base class's byte
    accounting reads it without knowing rows moved off-host."""
    width: int
    slot: int
    nbytes: int


class RowRef(NamedTuple):
    """Row ``index`` of a 2-D f32 device tensor ``block``, by reference.
    The engine hands its computed miss rows to ``put_many`` this way, so a
    wave's admissions reach the slab through one ``index_select`` of the
    block instead of one tensor per row."""
    block: torch.Tensor
    index: int

    @property
    def shape(self) -> tuple:
        return (self.block.shape[1],)

    @property
    def nbytes(self) -> int:
        return self.block.shape[1] * self.block.element_size()


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _row_block(rows: list, device) -> torch.Tensor:
    """The ``(n, d)`` tensor of ``rows`` (``RowRef``s and 1-D tensors): one
    ``index_select`` when every row refers to one block, else a stack."""
    first = rows[0]
    if isinstance(first, RowRef) and all(
            isinstance(r, RowRef) and r.block is first.block for r in rows):
        pos = torch.as_tensor([r.index for r in rows], dtype=torch.int64)
        return first.block.index_select(0, pos.to(device))
    return torch.stack([r.block[r.index] if isinstance(r, RowRef) else r for r in rows])


class DeviceHotRowCache(HotRowCache):
    """``HotRowCache`` with rows resident in device memory.

    Policy, accounting, and the event/replay contract are inherited
    unchanged — only storage moves: rows live in one f32 slab per table
    width (a ``(slots, d)`` tensor on ``device``), admission/eviction stay
    host-side over the same LFU/LRU bookkeeping, and writes batch into a
    single in-place ``index_copy_`` per width per wave (``flush``), so the
    hit path is a pure device gather — no per-row host transfer.

    The engine-facing batched API:

    * ``lookup_many(keys, counts)`` → ``(slots, miss_mask)`` — slot ids
      for resident keys (``-1`` for misses) with per-occurrence hit/miss
      accounting (one ``hit``/``miss`` event per *unique* key);
    * ``put_many(keys, rows, pinned=...)`` — admit computed miss rows,
      never evicting a pinned (this wave's hit) key; returns the admitted
      subset.  An admission that would require evicting a pinned row is
      skipped and counted as a rejection;
    * ``slab(width)`` / ``flush()`` — the gather target of the engine's
      slab forward.

    Every slab is allocated and written under ``torch.inference_mode``
    (the engine dispatches in it), whichever mode the caller is in.  All
    work runs on the current stream: a later wave's ``index_copy_`` runs
    after an earlier in-flight wave's gather from the same slab, and
    ``_grow`` replaces the slab tensor, so in-flight waves keep the old
    one.  Scalar ``get``/``put``/``replay`` still work; ``get`` flushes
    and copies the row back to the host (the compatibility path).
    """

    # Slabs whose full capacity fits under this row count are allocated at
    # capacity up front, so the slab's shape stays fixed while it fills.
    _PREALLOC_ROWS = 1 << 20

    def __init__(self, capacity_rows: Optional[int] = 4096,
                 policy: str = "lfu", record_events: bool = False,
                 capacity_bytes: Optional[int] = None, device="cuda"):
        super().__init__(capacity_rows=capacity_rows, policy=policy,
                         record_events=record_events,
                         capacity_bytes=capacity_bytes)
        self.device = torch.device(device)
        self._slabs: dict[int, torch.Tensor] = {}  # width -> (slots, d) f32
        self._free: dict[int, list[int]] = {}      # width -> free slot ids
        self._pending: dict[int, list] = {}        # width -> [(slot, row)]
        # bumped whenever key->slot residency changes; the engine keeps a
        # device-resident slot map and rebuilds it only when this moves
        self.residency_version = 0

    # ---- storage hooks ----------------------------------------------------
    def _coerce(self, row):
        if isinstance(row, RowRef):
            return row
        return torch.as_tensor(row, dtype=torch.float32, device=self.device).reshape(-1)

    def _store(self, key, row) -> None:
        d = int(row.shape[-1])
        rec = self._rows.get(key)
        if rec is not None and rec.width == d:
            slot = rec.slot                        # refresh in place
        else:
            if rec is not None:                    # width changed: move
                self._free[rec.width].append(rec.slot)
            slot = self._alloc(d)
        self._rows[key] = _Slot(d, slot, row.nbytes)
        self._pending.setdefault(d, []).append((slot, row))
        self.residency_version += 1

    def _release(self, key) -> None:
        rec = self._rows[key]
        self._free.setdefault(rec.width, []).append(rec.slot)
        self.residency_version += 1

    def _fetch(self, key):
        rec = self._rows[key]
        self.flush()
        return self._slabs[rec.width][rec.slot].cpu().numpy()

    def invalidate_all(self) -> int:
        """Base-class semantics (every drop is an invalidation), plus the
        storage teardown a plan swap needs: pending (unflushed) writes are
        discarded and the slabs themselves are released."""
        n = super().invalidate_all()   # releases every slot, bumps version
        self._slabs.clear()
        self._free.clear()
        self._pending.clear()
        self.residency_version += 1    # force slot-map rebuild even if empty
        return n

    # ---- slab management --------------------------------------------------
    def _max_rows(self, d: int) -> int:
        caps = []
        if self.capacity_rows is not None:
            caps.append(self.capacity_rows)
        if self.capacity_bytes is not None:
            caps.append(max(1, self.capacity_bytes // (4 * d)))
        return min(caps)

    def _grow(self, d: int) -> bool:
        """Create or double the width-``d`` slab (capped by capacity);
        returns False when already saturated."""
        cur = self._slabs.get(d)
        n = 0 if cur is None else cur.shape[0]
        cap = self._max_rows(d)
        grown = cap if cap <= self._PREALLOC_ROWS else min(cap, max(64, n * 2))
        if grown <= n:
            return False
        with torch.inference_mode():
            slab = torch.zeros((grown, d), dtype=torch.float32, device=self.device)
            if cur is not None:
                slab[:n] = cur
        self._slabs[d] = slab
        # descending so pop() hands out the lowest slot first
        self._free.setdefault(d, []).extend(range(grown - 1, n - 1, -1))
        return True

    def _alloc(self, d: int) -> int:
        free = self._free.setdefault(d, [])
        while not free:
            if self._grow(d):
                continue
            # slab saturated for this width (mixed-width byte budget):
            # evict the policy victim *of this width* to free a slot
            victims = [k for k, r in self._rows.items()
                       if r.width == d and k not in self._pins]
            if not victims:
                raise CachePinned(f"width-{d} slab saturated, all pinned")
            self._remove(min(victims, key=self._rank))
        return free.pop()

    def slab(self, d: int) -> torch.Tensor:
        """The ``(slots, d)`` f32 device slab for width ``d`` (gather
        target for slot ids from ``lookup_many``); created empty on first
        touch so an all-empty wave can still gather (masked to zero)."""
        if d not in self._slabs:
            self._grow(d)
        return self._slabs[d]

    def slots_for(self, keys: Sequence[Hashable]) -> np.ndarray:
        """Slot ids for resident ``keys`` (KeyError if any is missing —
        the engine only calls this after pinning the whole wave)."""
        return np.asarray([self._rows[k].slot for k in keys], np.int32)

    def slot_items(self) -> tuple[np.ndarray, np.ndarray]:
        """Every resident (key, slot) pair as two aligned arrays — the
        bulk export the engine's slot map is rebuilt from (keys are the
        engine's packed int64s)."""
        n = len(self._rows)
        keys = np.fromiter(self._rows.keys(), np.int64, n)
        slots = np.fromiter((rec.slot for rec in self._rows.values()),
                            np.int64, n).astype(np.int32)
        return keys, slots

    def flush(self) -> None:
        """Apply pending admissions as one in-place ``index_copy_`` per width.

        Slots are deduped last-write-wins (a slot freed by an eviction and
        reused within the same wave must land the newer row), and the write
        pads to the next power of two (at least 64) by repeating the final
        pair, so the duplicates all carry one row."""
        for d, writes in self._pending.items():
            if not writes:
                continue
            dedup = {}
            for slot, row in writes:
                dedup[slot] = row
            writes.clear()
            slots, rows = list(dedup), list(dedup.values())
            pad = max(64, _next_pow2(len(slots))) - len(slots)
            slots += slots[-1:] * pad
            rows += rows[-1:] * pad
            with torch.inference_mode():
                index = torch.as_tensor(slots, dtype=torch.int64).to(self.device)
                self._slabs[d].index_copy_(0, index, _row_block(rows, self.device))

    # ---- engine-facing batched API ---------------------------------------
    def lookup_many(self, keys: Sequence[Hashable], counts=None):
        """Slot ids for ``keys`` (``-1`` where missing) plus a miss mask.

        ``counts`` carries per-key occurrence counts (the engine passes
        ``np.unique`` counts) so hit/miss totals match the per-occurrence
        accounting of the host cache's ``get_many``."""
        n = len(keys)
        cnts = [1] * n if counts is None else \
            (counts.tolist() if hasattr(counts, "tolist") else list(counts))
        slot_list = [-1] * n
        miss_list = [False] * n
        # this loop runs once per unique key per wave on the serving hot
        # path — keep the body allocation-light and bind lookups to locals
        rows_get = self._rows.get
        freq, used = self._freq, self._used
        record, events = self.record_events, self.events
        moved = self._moved.add
        clock = self._clock
        hits = misses = 0
        for i, key in enumerate(keys):
            c = cnts[i]
            clock += 1
            rec = rows_get(key)
            if rec is None:
                misses += c
                if record:
                    events.append(("miss", key))
                miss_list[i] = True
            else:
                hits += c
                freq[key] += c
                used[key] = clock
                moved(key)
                if record:
                    events.append(("hit", key))
                slot_list[i] = rec.slot
        self._clock = clock
        self.stats.hits += hits
        self.stats.misses += misses
        return np.asarray(slot_list, np.int32), np.asarray(miss_list, bool)

    def put_many(self, keys: Sequence[Hashable], rows,
                 pinned: Iterable[Hashable] = ()) -> list:
        """Admit ``rows`` under ``keys`` without evicting ``pinned`` keys;
        flushes, then returns the keys actually admitted (an admission that
        could only proceed by evicting a pinned row is rejected)."""
        self._pinned = pinned
        admitted = []
        try:
            for key, row in zip(keys, rows):
                try:
                    self.put(key, row)
                except CachePinned:
                    self.stats.rejections += 1
                    self._event("reject", key)
                    continue
                if key in self._rows:
                    admitted.append(key)
        finally:
            self._pinned = ()
            # a pinned-blocked shed can leave the budget transiently over;
            # restore the invariant now that pins are released
            while self._over_bytes(0) and len(self._rows) > 1:
                self._evict_one()
        self.flush()
        return admitted

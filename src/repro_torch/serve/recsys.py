"""Continuous-batching recsys inference engine over quantized tables.

Each request is *one* scoring call carrying 13 dense floats plus a
variable-length multi-hot id bag per categorical feature.  The engine:

* **queues** requests and forms waves by **continuous batching**
  (``batching="continuous"``, the default): the head request anchors the
  wave's bag-length bucket and up to ``max_batch`` same-bucket requests
  from a bounded lookahead window ride along; the head always ships in
  the next wave, so nothing starves.  ``batching="waves"`` takes strict
  FIFO slices;
* **pads + buckets** every wave to a fixed shape — batch and bag length
  each round up to a power of two.  Padded bag slots carry ``mask = 0``
  (they contribute exactly nothing) and padded batch rows are sliced off
  before scores land;
* **pipelines** waves: up to ``max_inflight`` waves ride PyTorch's
  asynchronous launches before the engine waits on the oldest, so host
  wave formation overlaps device execution (continuous mode only);
* runs the **quantized forward** (int8/bf16 tables via ``serve.quantize``;
  the fused serving kernel and the interaction kernel when
  ``cfg.use_kernel``) as an embed stage and a dense stage — every path
  (cache off, host cache, device cache) feeds its ``(B, F, D)`` features
  to the same dense stage, so the cache cannot perturb the dense math;
* serves hot rows from the **hot-row cache** when given: a
  ``DeviceHotRowCache`` keeps combined dequantized rows resident in device
  slabs, and only *miss* rows are computed from the tables.  Three
  branches serve a wave: the speculative in-graph slot-map probe
  (``fast``, id spaces up to ``_SLOT_MAP_ROWS_MAX`` rows), the exact
  host-side lookup (``exact``), and, when admission is refused because
  the wave's working set exceeds what the cache can pin, the cache-off
  embed (``ingraph``); ``metrics()["cache_paths"]`` counts them.  A host
  ``HotRowCache`` also works (rows pooled on the host, the compatibility
  path);
* tracks per-wave dispatch→ready wall time → **p50/p99 latency and QPS**
  via ``metrics()``;
* with ``obs=Obs(...)`` (``repro_torch.obs``), partitions each wave's
  latency into stages (``STAGES``) in the metrics registry and the
  tracer, and records the served ids into the collision telemetry from
  the host arrays each wave is padded into (never a read back from the
  device).  With ``obs=None`` the engine makes no extra clock read and
  does no registry work.

* serves **sharded** with ``mesh_devices=N``: every rank of a
  ``torch.distributed`` group of N runs the engine on the same request
  stream (a rank stands where a device of the reference's mesh stood).
  The tables are placed by ``dist.serve_placement`` (replicate small
  sub-tables, row-shard big ones; ``placement=`` or ``plan=`` steer it);
  each rank serves its slice of every padded wave, fetching remote rows
  of the sharded sub-tables through the two-phase all-to-all exchange
  (``exchange_rows``, the ``gather=`` hook of ``embed_features``), and
  the per-rank scores are gathered so every rank returns the whole wave.
  Replicated features keep the fused kernel (one grouped launch); a
  ``DeviceHotRowCache`` is mirrored per rank and holds replicated
  features only.

* serves **on a DTensor mesh** with ``mesh=`` (a named ``DeviceMesh``,
  ``launch.mesh.make_local_mesh``): every rank of the mesh's group runs
  the engine on the same request stream.  The parameters are laid out by
  ``tree_shardings(params, mesh, INFERENCE_OVERRIDES)`` (the reference's
  placement minus FSDP); the dense stage runs on DTensors, the wave's
  rows split over the data axis.  The kernels take plain tensors: a leaf
  whole on every mesh dim of size > 1 gives its local tensor, any other
  is gathered whole (``full_tensor``, the gather GSPMD puts around a
  custom call), at most once a wave and only where the wave reads it, and
  ``metrics()["mesh"]`` counts those bytes.  The hot-row cache serves
  as on one device: its rows are computed from the same whole tables, so
  a (1, 1) mesh runs the unmeshed cached engine's device work.
  ``mesh=`` and ``mesh_devices=`` are two layouts: give one.

Deterministic given (params, request stream): no sampling, logical-clock
cache, fixed bucket grid, sorted unique keys.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import CompositionalEmbedding, HashEmbedding, is_quantized_table
from ..models.dcn import DCNConfig, dcn_forward_from_features
from ..models.dlrm import (DLRMConfig, _project, dlrm_forward_from_features, embed_features,
                           tables_for)
from .cache import CacheStats, DeviceHotRowCache, HotRowCache, RowRef

__all__ = ["RecRequest", "RecsysEngine", "BATCHING_MODES"]

BATCHING_MODES = ("continuous", "waves")

_FEATURE_SHIFT = 44  # packed key: (feature << 44) | canonical row id
# ceiling on the device slot map (int32 per cacheable row, 64 MiB):
# configs whose total canonical id space exceeds it skip the in-graph
# probe and use the exact host-side lookup instead
_SLOT_MAP_ROWS_MAX = 1 << 24

# stage names: the five partition stages tile the measured wave-latency
# interval [dispatch t0, reap t1] with contiguous boundary timestamps, so
# their sum equals the recorded latency by construction; queue_wait and pad
# happen before t0 and ride along as extra, non-partition stages.  flush is
# the wait for the device (the scores' copy to the host)
STAGE_PARTITION = ("probe", "dense", "inflight", "miss_gather", "flush")
STAGES = ("queue_wait", "pad") + STAGE_PARTITION

# the programs whose input-shape signatures ``compile_count`` reports
_PROGRAMS = ("embed", "dense", "slab", "fast")
_SHARDED_PROGRAMS = ("sharded_embed", "sharded_dense", "sharded_fast")
# the branches a device-cache wave is served by (``metrics()["cache_paths"]``);
# ``probe_missed`` counts fast probes whose wave was recomputed exactly
_CACHE_PATHS = ("fast", "exact", "ingraph", "probe_missed", "host")


@dataclasses.dataclass
class RecRequest:
    uid: int
    dense: np.ndarray              # (dense_dim,)
    bags: list[list[int]]          # one multi-hot id bag per categorical
    score: Optional[float] = None
    done: bool = False
    t_submit: Optional[float] = None   # monotonic enqueue time (obs on only)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` is the current card, so it and
    ``cuda:N`` for that card are the same)."""
    if a.type != b.type or a.type != "cuda":
        return a == b
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


def _dense_stage_for(cfg):
    if isinstance(cfg, DLRMConfig):
        return dlrm_forward_from_features
    if isinstance(cfg, DCNConfig):
        return dcn_forward_from_features
    raise TypeError(f"no recsys serving path for config {type(cfg).__name__}")


def _row_dtype(tp) -> torch.dtype:
    """Dtype of the combined row ``module.apply`` yields for this table's
    params: f32 once any side is row-quantized (dequant widens), else the
    stored table dtype — the slab forward casts its f32 pooled bag back to
    this, as ``bag_pool`` does."""
    sub = tp.get("table", tp.get("table_0"))
    return torch.float32 if is_quantized_table(sub) else sub.dtype


class RecsysEngine:
    def __init__(self, cfg, params, *, max_batch: int = 32,
                 cache: Optional[HotRowCache] = None, mesh=None,
                 batching: str = "continuous", max_inflight: int = 2,
                 lookahead: Optional[int] = None,
                 mesh_devices: Optional[int] = None, placement=None,
                 plan=None, obs=None, device="cuda"):
        if batching not in BATCHING_MODES:
            raise ValueError(f"batching={batching!r} not in {BATCHING_MODES}")
        if mesh is not None and mesh_devices is not None:
            raise ValueError("mesh= (parameters laid out as DTensors) and mesh_devices= "
                             "(tables placed over the ranks) are two layouts: give one")
        if mesh is not None and not getattr(mesh, "mesh_dim_names", None):
            raise TypeError(f"mesh= takes a named DeviceMesh (launch.mesh.make_local_mesh), "
                            f"got {type(mesh).__name__}")
        self.mesh = mesh
        self.mesh_gather_bytes = 0
        self._wave_whole: Optional[dict] = None
        if cfg.embedding.kind == "feature":
            raise NotImplementedError(
                "feature-generation mode has no serving path (F varies)")
        self.device = torch.device(device)
        if isinstance(cache, DeviceHotRowCache) and not _same_device(cache.device, self.device):
            raise ValueError(f"the cache's slabs live on {cache.device}, the engine serves "
                             f"on {self.device}: build the cache on the engine's device")
        self.cache = cache
        self.max_batch = max_batch
        self.batching = batching
        self.max_inflight = max_inflight
        self.lookahead = lookahead or 4 * max_batch
        self._n_shards = int(mesh_devices or 1)
        self._gathers = None
        if self._n_shards > 1:
            if cache is not None and not isinstance(cache, DeviceHotRowCache):
                raise NotImplementedError(
                    "sharded serving supports DeviceHotRowCache only (host cache rows are "
                    "not locally resident on every rank)")
            if max_batch % self._n_shards or max_batch < self._n_shards:
                raise ValueError(f"max_batch={max_batch} must be a positive multiple of "
                                 f"mesh_devices={self._n_shards}")
            params = self._init_sharded(cfg, params, placement, plan)
        self._install_model(cfg, params)
        if self._n_shards > 1:
            self._build_sharded()
        self._queue: deque[RecRequest] = deque()
        self._inflight: deque[tuple] = deque()
        self._next_uid = 0
        self.completed: dict[int, RecRequest] = {}
        self.wave_latencies_s: list[float] = []
        self.wave_sizes: list[int] = []
        self.buckets_seen: set[tuple[int, int]] = set()
        self.cache_paths = dict.fromkeys(_CACHE_PATHS, 0)
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

        # observability: everything below is skipped when obs is None (the
        # off-by-default contract: obs-off waves take no extra clock read
        # and no registry work, which keeps the obs lane's QPS comparison
        # honest)
        self._obs = obs
        if obs is not None:
            obs.attach_collisions(cfg.table_sizes)
            # label handles bound once: the hot path never hashes a dict
            hs = obs.histogram("serve_stage_seconds",
                               "per-wave stage durations (see STAGES)")
            self._h_stage = {s: hs.labels(stage=s) for s in STAGES}
            self._h_wave = obs.histogram(
                "serve_wave_latency_seconds",
                "dispatch->ready wall time per wave").labels()
            self._c_req = obs.counter("serve_requests_total", "requests scored").labels()
            self._c_waves = obs.counter("serve_waves_total", "waves dispatched").labels()
            self._c_wire = obs.counter(
                "serve_wire_bytes_total", "serve-exchange bytes moved between ranks").labels(
                    collective="serve_exchange") if self._n_shards > 1 else None
            self._wire_by_bucket: dict[tuple[int, int], int] = {}

    # ------------------------------------------------------------- model

    def _install_model(self, cfg, params) -> None:
        """Bind (cfg, params) and (re)build everything derived from them:
        the dense stage, the slab layout by width, the flat canonical-id
        layout of the slot map, and the programs' signature sets.  Called
        once from ``__init__`` and again by ``swap_plan``, between waves."""
        self.cfg = cfg
        self.modules = tables_for(cfg)
        self.params = _to_device(params, self.device)
        if self.mesh is not None:
            self.params = self._distribute(self.params)
        self._dense_stage = _dense_stage_for(cfg)

        widths = tuple(sorted({mod.out_dim for mod in self.modules}))
        self._widths = widths
        self._w_index = {d: wi for wi, d in enumerate(widths)}
        self._feat_width = tuple(mod.out_dim for mod in self.modules)
        self._row_dtypes = tuple(_row_dtype(tp) for tp in self.params["tables"])
        # one width, one row dtype, no projection: the slab forward pools
        # every feature in one gather
        self._uniform = (len(widths) == 1 and len(set(self._row_dtypes)) == 1
                         and not self.params.get("proj"))

        # flat canonical-id layout for the slot map: feature i's canonical
        # rows occupy [offset_i, offset_i + space_i), so one int32 device
        # tensor maps every cacheable row to its slab slot (-1 = not resident)
        spaces = [mod.m if isinstance(mod, HashEmbedding) else size
                  for mod, size in zip(self.modules, cfg.table_sizes)]
        self._flat_offsets = np.concatenate([[0], np.cumsum(spaces)[:-1]]).astype(np.int64)
        self._flat_total = int(sum(spaces))
        self._slot_map = None
        self._map_version = None
        # canonicalization is part of the probe: hash features fold mod m,
        # QR/full ids are already < their space, so the same modulus is a
        # no-op for them
        self._space_arr = torch.as_tensor(spaces, dtype=torch.int32,
                                          device=self.device)[None, :, None]
        self._off_arr = torch.as_tensor(self._flat_offsets, dtype=torch.int32,
                                        device=self.device)[None, :, None]
        self._signatures = {name: set() for name in
                            (_SHARDED_PROGRAMS if self._n_shards > 1 else _PROGRAMS)}

    def _seen(self, program: str, *tensors) -> None:
        self._signatures[program].add(tuple((tuple(t.shape), t.dtype) for t in tensors))

    def _embed_fwd(self, idx, mask):
        self._seen("embed" if self._gathers is None else "sharded_embed", idx, mask)
        tables = [self._read("tables", i) for i in range(len(self.modules))]
        feats = embed_features(tables, idx, self.cfg, modules=self.modules, mask=mask,
                               proj=self._read("proj"), gathers=self._gathers)
        return feats if torch.is_tensor(feats) else torch.stack(feats, dim=1)

    def _dense_fwd(self, dense, feats):
        self._seen("dense", dense, feats)
        if self.mesh is None:
            return self._dense_stage(self.params, dense, feats, self.cfg)
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor.experimental import implicit_replication

        from ..dist.sharding import constrain_batch
        whole = (Replicate(),) * self.mesh.ndim
        dense, feats = (constrain_batch(DTensor.from_local(x, self.mesh, whole, run_check=False))
                        for x in (dense, feats))
        with implicit_replication():
            return self._dense_stage(self.params, dense, feats, self.cfg).full_tensor()

    # ------------------------------------------------------------- the mesh

    def _distribute(self, params):
        """``params`` as DTensors on ``self.mesh`` by the inference
        placement, each rank cutting its own blocks (nothing crosses the
        wire)."""
        from .. import tree
        from ..dist.sharding import INFERENCE_OVERRIDES, distribute, tree_shardings
        shardings = tree.leaves(tree_shardings(params, self.mesh, INFERENCE_OVERRIDES))
        return tree.unflatten(params, [distribute(leaf, sh) for leaf, sh in
                                       zip(tree.leaves(params), shardings)])

    def _whole(self, params):
        """Plain tensors for the kernels: a leaf whole on every mesh dim of
        size > 1 gives its local tensor, any other is gathered whole
        (``full_tensor``) and its received bytes counted."""
        if params is None:
            return None
        from torch.distributed.tensor import Replicate

        from .. import tree
        out = []
        for leaf in tree.leaves(params):
            if all(isinstance(p, Replicate) or self.mesh.size(i) == 1
                   for i, p in enumerate(leaf.placements)):
                out.append(leaf.to_local())
                continue
            full = leaf.full_tensor()
            self.mesh_gather_bytes += (full.numel() - leaf.to_local().numel()) \
                * full.element_size()
            out.append(full)
        return tree.unflatten(params, out)

    @contextlib.contextmanager
    def _wave_tables(self):
        """One wave's reads of the parameters: on a mesh, each table (and
        ``proj``) a wave reads is made whole once and kept until the wave's
        work is launched, so a wave whose admission is refused after its
        miss rows were computed gathers those tables once."""
        self._wave_whole = {}
        try:
            yield
        finally:
            self._wave_whole = None

    def _read(self, key, i=None):
        """``params[key]`` (``params[key][i]`` for a table) as the kernels
        and the cache paths read it: the parameters themselves off a mesh,
        else plain tensors by ``_whole``, once a wave."""
        leaf = self.params.get(key) if i is None else self.params[key][i]
        if self.mesh is None:
            return leaf
        memo = self._wave_whole
        if memo is None:
            return self._whole(leaf)
        if (key, i) not in memo:
            memo[key, i] = self._whole(leaf)
        return memo[key, i]

    def _slab_pool(self, slabs, slots, mask):
        """Gather each feature's rows from its width's slab, mask-pool them
        in f32 and cast to the row dtype (``bag_pool``'s expression), then
        project mixed-width features into the interaction width."""
        m = mask.to(torch.float32)
        if self._uniform:
            rows = slabs[0][slots]                                   # (B, F, L, D)
            return torch.sum(rows * m[..., None], dim=2,
                             dtype=torch.float32).to(self._row_dtypes[0])
        proj = self._read("proj") or {}
        feats = []
        for i, d in enumerate(self._feat_width):
            rows = slabs[self._w_index[d]][slots[:, i, :]]           # (B, L, d)
            pooled = torch.sum(rows * m[:, i, :, None], dim=-2,
                               dtype=torch.float32).to(self._row_dtypes[i])
            w = proj.get(str(i))
            feats.append(pooled if w is None else pooled @ w)
        return torch.stack(feats, dim=1)

    def _slab_fwd(self, slabs, slots, mask):
        self._seen("slab", *slabs, slots, mask)
        return self._slab_pool(slabs, slots, mask)

    def _fast_fwd(self, smap, idx, mask, slabs):
        """Probe + gather + pool in one go: fold ids to flat canonical ids,
        read their slots from the map, and count live slots not resident."""
        self._seen("fast", smap, idx, mask, *slabs)
        slots = smap[idx % self._space_arr + self._off_arr]
        nmiss = torch.sum((slots < 0) & (mask > 0))
        return self._slab_pool(slabs, slots, mask), nmiss

    def swap_plan(self, cfg, params, *, warm: bool = True) -> dict:
        """Hot-swap to a new plan's (cfg, params) without downtime.

        1. **drain** — in-flight waves hold references to the old params
           and slabs, so they settle on the old plan;
        2. **invalidate** — every cached row is a *combined* row of the
           old structure, so the whole residency is dropped as
           invalidations, device slabs are released, and
           ``residency_version`` moves so the slot map is rebuilt;
        3. **install** — ``_install_model`` rebinds cfg/params;
        4. **pre-warm** (``warm=True``) — one dummy wave per (batch, bag)
           bucket this engine has served runs through the same path
           selection as ``_dispatch``, off the wave path (it admits each
           feature's row 0 into the cache, and no metrics see it).

        The queue, uid space, metrics history and completed map survive.
        A meshed engine (``mesh=``) lays the new parameters out on its mesh
        as ``__init__`` did.  Not with ``mesh_devices=``: a sharded swap
        would also re-solve the placement and reshard the tables."""
        if self._n_shards > 1:
            raise NotImplementedError(
                "swap_plan is single-host only: a sharded swap must also re-solve placement "
                "and reshard the tables")
        if cfg.embedding.kind == "feature":
            raise NotImplementedError(
                "feature-generation mode has no serving path (F varies)")
        if tuple(cfg.table_sizes) != tuple(self.cfg.table_sizes):
            raise ValueError("swap_plan keeps the feature set: table_sizes "
                             "must match the running config")
        while self._inflight:            # 1. drain on the old plan
            self._reap()
        dropped = 0
        if self.cache is not None:       # 2. stale residency out
            dropped = self.cache.invalidate_all()
        self._install_model(cfg, params)  # 3. new plan in
        if warm:                         # 4. every served bucket once
            self._warm_buckets()
        return {"invalidated_rows": dropped,
                "buckets_warmed": sorted(self.buckets_seen) if warm else [],
                "residency_version": getattr(self.cache, "residency_version", None)}

    def _warm_buckets(self) -> None:
        """One dummy wave per previously seen (batch, bag) bucket through
        the same path selection as ``_dispatch``, outside the wave and
        metrics bookkeeping."""
        f = len(self.modules)
        dense_dim = getattr(self.cfg, "dense_dim", 13)
        for bb, lb in sorted(self.buckets_seen):
            dense = np.zeros((bb, dense_dim), np.float32)
            idx = np.zeros((bb, f, lb), np.int32)
            mask = np.zeros((bb, f, lb), np.float32)
            mask[:, :, 0] = 1.0  # one live slot: exercises the miss path
            with torch.inference_mode(), self._wave_tables():
                if isinstance(self.cache, DeviceHotRowCache) \
                        and not self.cache.record_events:
                    fast = self._embed_device_fast(idx, mask)
                    if fast is None or int(fast[1]):
                        feats, _ = self._embed_device(idx, mask)
                    else:
                        feats = fast[0]
                elif self.cache is not None:
                    feats = self._host(self._embed_cached(idx, mask))
                else:
                    feats = self._embed_fwd(self._host(idx), self._host(mask))
                self._dense_fwd(self._host(dense), feats).to("cpu")

    # ------------------------------------------------------------- sharding

    def _init_sharded(self, cfg, params, placement, plan):
        """Place the tables over the ranks of the default process group per
        the plan-aware placement (``dist.serve_placement``): sub-tables below
        the replication threshold stay whole on every rank, big ones keep
        this rank's row block.  Returns this rank's parameters."""
        import torch.distributed as dist

        from ..dist.serve_placement import place_params, plan_placement
        n = self._n_shards
        if not dist.is_initialized():
            raise RuntimeError(
                f"mesh_devices={n}: sharded serving runs one rank per device in a "
                "torch.distributed group, and none is initialized (run under torchrun, or "
                "call torch.distributed.init_process_group)")
        if dist.get_world_size() != n:
            raise ValueError(f"mesh_devices={n} but the process group has "
                             f"{dist.get_world_size()} ranks")
        self._rank = dist.get_rank()
        if placement is None:
            placement = plan_placement(params, n, plan=plan)
        if placement.n_devices != n:
            raise ValueError(f"placement built for {placement.n_devices} devices, engine "
                             f"asked for {n}")
        self.placement = placement
        placed, _ = place_params(params, placement, self._rank)
        # only fully replicated features are cacheable: a row-sharded
        # feature's rows are not resident on every rank
        self._repl_live = placement.replicated_features(len(tables_for(cfg)))
        return placed

    def _build_sharded(self) -> None:
        """The ``gather=`` hooks of the sharded embed: a row-sharded
        sub-table fetches its rows through the exchange, a replicated
        sub-table of a sharded feature gathers locally, and a fully
        replicated feature has no hook (its kernel route stays)."""
        from ..core.compositional import table_rows
        from ..dist.serve_placement import exchange_rows
        n = self._n_shards
        rpd = {(e.feature, e.table_key): self.placement.rows_per_device(e)
               for e in self.placement.sharded}

        def gather_for(i):
            if self._repl_live[i]:
                return None

            def g(leaf, ids, key):
                r = rpd.get((i, key))
                if r is None:
                    return table_rows(leaf, ids)
                return exchange_rows(leaf, ids, n, r, leaf_path=f"tables/{i}/{key}")
            return g

        self._gathers = [gather_for(i) for i in range(len(self.modules))]

    def _local(self, array: np.ndarray) -> torch.Tensor:
        """This rank's block of a padded wave's host array, on the device."""
        per = array.shape[0] // self._n_shards
        return self._host(np.ascontiguousarray(array[self._rank * per:(self._rank + 1) * per]))

    def _sharded_dense(self, dense: np.ndarray, feats):
        """The dense stage on this rank's block, then every rank's scores
        gathered in rank order: each rank returns the whole wave."""
        from ..dist import wire
        d = self._local(dense)
        self._seen("sharded_dense", d, feats)
        return wire.all_gather(self._dense_stage(self.params, d, feats, self.cfg), None,
                               leaf="_scores")

    def _sharded_fast_fwd(self, smap, idx, mask, slabs):
        """The fast path on this rank's block: replicated features from the
        slabs through the slot map, sharded features from their tables (they
        are never cached); the miss count covers cacheable slots only and
        is summed over the group, so every rank takes the same branch."""
        from ..core.compositional import bag_pool
        from ..dist import wire
        self._seen("sharded_fast", smap, idx, mask, *slabs)
        slots = smap[idx % self._space_arr + self._off_arr]
        m = mask.to(torch.float32)
        proj = self.params.get("proj")
        feats, nmiss = [], torch.zeros((), dtype=torch.int64, device=idx.device)
        for i, mod in enumerate(self.modules):
            if self._repl_live[i]:
                rows = slabs[self._w_index[self._feat_width[i]]][slots[:, i, :]]
                pooled = torch.sum(rows * m[:, i, :, None], dim=-2,
                                   dtype=torch.float32).to(self._row_dtypes[i])
                nmiss = nmiss + torch.sum((slots[:, i, :] < 0) & (mask[:, i, :] > 0))
            else:
                pooled = bag_pool(mod, self.params["tables"][i], idx[:, i, :], mask[:, i, :],
                                  gather=self._gathers[i])
            feats.append(_project(pooled, proj, i))
        return torch.stack(feats, dim=1), wire.all_reduce(nmiss, None, leaf="_nmiss")

    def _admit_cacheable(self, idx: np.ndarray, mask: np.ndarray) -> None:
        """Sharded admission: look up and admit the whole wave's *cacheable*
        (replicated-feature) rows with full per-key accounting, computing
        only the miss rows from the local tables.  Every rank admits the
        same keys, so the per-rank caches stay mirrors."""
        cache = self.cache
        f = idx.shape[1]
        live = (mask > 0) & self._repl_live[None, :, None]
        packed = self._canonical(idx) + (np.arange(f, dtype=np.int64)[None, :, None]
                                         << _FEATURE_SHIFT)
        keys_live = packed[live]
        if not keys_live.size:
            return
        uniq, counts = np.unique(keys_live, return_counts=True)
        key_list = uniq.tolist()
        _, miss_u = cache.lookup_many(key_list, counts)
        if miss_u.any():
            rows = self._compute_miss_rows(uniq[miss_u])
            cache.put_many(uniq[miss_u].tolist(), rows, pinned=key_list)

    def _dispatch_sharded(self, dense, idx, mask):
        """One wave through the sharded path; returns ``(logits, check,
        ta)`` with the single-host device-cache path's speculative-probe
        contract (``ta`` is the probe/dense stage boundary, None when obs
        is off)."""
        check = None
        if (isinstance(self.cache, DeviceHotRowCache) and not self.cache.record_events
                and self._flat_total <= _SLOT_MAP_ROWS_MAX and self._repl_live.any()):
            slabs = tuple(self.cache.slab(d) for d in self._widths)
            feats, nmiss = self._sharded_fast_fwd(self._sync_slot_map(), self._local(idx),
                                                  self._local(mask), slabs)
            check = (dense, idx, mask, nmiss)
        else:
            if self.cache is not None:
                self._admit_cacheable(idx, mask)
                self.cache_paths["ingraph"] += 1
            feats = self._embed_fwd(self._local(idx), self._local(mask))
        ta = time.monotonic() if self._obs is not None else None
        return self._sharded_dense(dense, feats), check, ta

    # ------------------------------------------------------------- intake

    def submit(self, dense, bags: Sequence[Sequence[int]]) -> int:
        """Queue one request.  Bags may be empty (a user with no history for
        that feature): an empty bag pools to the exact zero vector.  Ids are
        checked against each table's size here, on the host: the kernels
        read rows by address and take ids as given."""
        if len(bags) != len(self.modules):
            raise ValueError(f"expected {len(self.modules)} feature bags, "
                             f"got {len(bags)}")
        bags = [list(b) for b in bags]
        for i, (bag, size) in enumerate(zip(bags, self.cfg.table_sizes)):
            if bag and not (0 <= min(bag) and max(bag) < size):
                raise ValueError(f"feature {i}: ids must lie in [0, {size})")
        uid = self._next_uid
        self._next_uid += 1
        self._queue.append(RecRequest(
            uid, np.asarray(dense, np.float32), bags,
            t_submit=time.monotonic() if self._obs is not None else None))
        return uid

    # ------------------------------------------------------------- batching

    @staticmethod
    def _bucket(r: RecRequest) -> int:
        return _next_pow2(max((len(b) for b in r.bags), default=1) or 1)

    def _form_wave(self) -> list[RecRequest]:
        """Next wave off the queue.

        ``waves`` mode: strict FIFO slice of up to ``max_batch``.
        Continuous mode: the head request anchors the bag-length bucket; up
        to ``max_batch`` same-bucket requests within the first
        ``lookahead`` queued requests join it, everything else keeps its
        place.
        """
        q = self._queue
        if not q:
            return []
        if self.batching == "waves":
            return [q.popleft() for _ in range(min(self.max_batch, len(q)))]
        anchor = self._bucket(q[0])
        wave: list[RecRequest] = []
        skipped: list[RecRequest] = []
        scanned = 0
        while q and len(wave) < self.max_batch and scanned < self.lookahead:
            r = q.popleft()
            scanned += 1
            if self._bucket(r) == anchor:
                wave.append(r)
            else:
                skipped.append(r)
        for r in reversed(skipped):
            q.appendleft(r)
        return wave

    def _pad_wave(self, wave: list[RecRequest]):
        """(dense (Bb, 13), idx (Bb, F, Lb) int32, mask (Bb, F, Lb) f32).

        ``Lb`` is at least 1 even for an all-empty wave (every bag empty):
        the padded slots carry mask 0, so they pool to zero vectors."""
        f = len(self.modules)
        lb = _next_pow2(max((len(b) for r in wave for b in r.bags), default=1) or 1)
        if self._n_shards > 1:
            # bucket the *per-rank* batch: each rank serves Bb/n rows, and
            # parity with a single-device engine holds when that equals its
            # bucket
            per = -(-len(wave) // self._n_shards)
            bb = min(_next_pow2(per), self.max_batch // self._n_shards) * self._n_shards
        else:
            bb = min(_next_pow2(len(wave)), self.max_batch)
        dense = np.zeros((bb, wave[0].dense.shape[0]), np.float32)
        idx = np.zeros((bb, f, lb), np.int32)
        mask = np.zeros((bb, f, lb), np.float32)
        for b, r in enumerate(wave):
            dense[b] = r.dense
            for i, bag in enumerate(r.bags):
                idx[b, i, :len(bag)] = bag
                mask[b, i, :len(bag)] = 1.0
        self.buckets_seen.add((bb, lb))
        return dense, idx, mask

    def _host(self, array: np.ndarray) -> torch.Tensor:
        """A wave's host array on the engine's device (a blocking copy: the
        arrays are made anew for every wave and never reused)."""
        return torch.from_numpy(array).to(self.device)

    # ------------------------------------------------------------- cache path

    def _row_key(self, feature: int, gid: int):
        """(table, quotient, remainder) cache key for one raw id,
        canonicalized through the module's own bucketing so ids that share
        an embedding row share a cache entry (hash tables fold mod m)."""
        mod = self.modules[feature]
        if isinstance(mod, CompositionalEmbedding) and len(mod.partitions) == 2:
            m = mod.partitions[0].num_buckets
            return (feature, gid // m, gid % m)
        if isinstance(mod, HashEmbedding):
            return (feature, 0, gid % mod.m)
        return (feature, 0, gid)

    def _canonical(self, idx: np.ndarray) -> np.ndarray:
        """Fold raw ids (Bb, F, Lb) to canonical row ids per feature:
        hash tables share rows mod m; QR/full ids are already 1:1 with
        their (quotient, remainder) row, so the id itself canonicalizes."""
        canon = np.empty(idx.shape, np.int64)
        for i, mod in enumerate(self.modules):
            col = idx[:, i, :].astype(np.int64)
            canon[:, i, :] = col % mod.m if isinstance(mod, HashEmbedding) else col
        return canon

    def _compute_miss_rows(self, miss_keys: np.ndarray) -> list:
        """Combined dequantized f32 rows for packed miss keys, one padded
        gather per feature (``module.apply`` is elementwise per row, so
        these rows are bit-identical to what the in-graph embed computes).
        The rows of each width are joined into one block and handed out as
        ``RowRef``s into it, so admission writes them with one gather.  On
        a mesh only the features with misses have their tables read."""
        feats_of = (miss_keys >> _FEATURE_SHIFT).astype(np.int64)
        gids = (miss_keys & ((1 << _FEATURE_SHIFT) - 1)).astype(np.int64)
        rows_out: list = [None] * len(miss_keys)
        parts: dict[int, list] = {}
        for i in np.unique(feats_of).tolist():
            sel = np.flatnonzero(feats_of == i)
            ids = gids[sel]
            # pad the fill-gather to a floored power of two, as the
            # reference does: the gather shapes stay O(log) in number
            n_pad = max(32, _next_pow2(len(ids)))
            padded = np.concatenate([ids, np.repeat(ids[-1:], n_pad - len(ids))])
            rows = self.modules[i].apply(self._read("tables", i),
                                         self._host(padded.astype(np.int32)))
            parts.setdefault(self._feat_width[i], []).append((sel, rows.to(torch.float32)))
        for group in parts.values():
            block = group[0][1] if len(group) == 1 else torch.cat([r for _, r in group])
            start = 0
            for sel, rows in group:
                for j, pos in enumerate(sel.tolist(), start):
                    rows_out[pos] = RowRef(block, j)
                start += rows.shape[0]
        return rows_out

    def _sync_slot_map(self) -> torch.Tensor:
        """Device slot map (flat canonical id -> slab slot, -1 = miss),
        rebuilt from the cache's residency only when it changed — at a
        steady hit rate this is a no-op and the hit path never touches a
        Python dict."""
        ver = self.cache.residency_version
        if self._slot_map is None or ver != self._map_version:
            smap = np.full(self._flat_total, -1, np.int32)
            keys, slots = self.cache.slot_items()
            if len(keys):
                feats = keys >> _FEATURE_SHIFT
                canon = keys & ((1 << _FEATURE_SHIFT) - 1)
                smap[self._flat_offsets[feats] + canon] = slots
            self._slot_map = self._host(smap)
            self._map_version = ver
        return self._slot_map

    def _embed_device_fast(self, idx: np.ndarray, mask: np.ndarray):
        """Speculative wave via the in-graph slot-map probe: fold ids,
        probe the map, gather/pool from the slabs — launched with no
        per-key host work and no host<->device sync.  Returns ``(feats,
        nmiss)`` where ``nmiss`` is a device scalar the caller checks *at
        reap time*: nonzero means some row was not resident, the
        speculative features are garbage, and the wave is recomputed
        through the exact path.  Returns ``None`` when the config's id
        space is too big to map.

        Stream order makes speculation safe: every cache operation runs on
        the current stream, so a later admission's ``index_copy_`` runs
        after this wave's gathers, and the slabs this wave reads are the
        slabs that were resident when it was launched.

        The fast path batches accounting: per-wave hit totals land in
        ``stats`` but per-key LFU/LRU freshness is only refreshed by the
        exact path (miss waves and ``record_events`` runs)."""
        if self._flat_total > _SLOT_MAP_ROWS_MAX:
            return None
        smap = self._sync_slot_map()
        slabs = tuple(self.cache.slab(d) for d in self._widths)
        return self._fast_fwd(smap, self._host(idx), self._host(mask), slabs)

    def _embed_device(self, idx: np.ndarray, mask: np.ndarray):
        """Wave features via the device-resident cache, and the branch that
        served them (``"exact"`` or ``"ingraph"``): one packed
        ``np.unique`` over the wave's live (feature, row) keys, slot
        lookups host-side, miss rows computed once and admitted through a
        batched scatter, then one slab gather→pool.

        This is the *exact* path: full per-key accounting (stats, LFU/LRU
        freshness, event log) with ``HotRowCache``'s semantics.  The whole
        wave's keys are pinned during admission so an in-wave eviction
        never reassigns a slot the gather is about to read; if admission
        is refused anyway (a cache smaller than the wave's working set),
        the wave is served by the cache-off embed — the same math, and
        the stats already counted."""
        cache = self.cache
        bb, f, lb = idx.shape
        canon = self._canonical(idx)
        packed = canon + (np.arange(f, dtype=np.int64)[None, :, None] << _FEATURE_SHIFT)
        live = mask > 0
        keys_live = packed[live]
        if keys_live.size:
            uniq, inv, counts = np.unique(keys_live, return_inverse=True, return_counts=True)
        else:
            uniq = inv = counts = np.empty(0, np.int64)
        key_list = uniq.tolist()
        slots_u, miss_u = cache.lookup_many(key_list, counts)
        if miss_u.any():
            miss_keys = uniq[miss_u]
            rows = self._compute_miss_rows(miss_keys)
            admitted = cache.put_many(miss_keys.tolist(), rows, pinned=key_list)
            if len(admitted) != len(miss_keys):
                return self._embed_fwd(self._host(idx), self._host(mask)), "ingraph"
            # the whole wave is pinned, so no hit row was evicted: only the
            # misses need their slots
            slots_u[miss_u] = cache.slots_for(miss_keys.tolist())
        slots = np.zeros((bb, f, lb), np.int32)
        if key_list:
            slots[live] = slots_u[inv]
        slabs = tuple(cache.slab(d) for d in self._widths)
        return self._slab_fwd(slabs, self._host(slots), self._host(mask)), "exact"

    def _embed_cached(self, idx: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Pooled features (Bb, F, D) via the host hot-row cache.

        Cached unit: the *combined* (post-op, dequantized) f32 row per
        (table, quotient, remainder), at the table's own width; the pooled
        bag is projected into the interaction width afterwards.  An empty
        bag has no live slots and stays the zero vector.  Misses are
        computed in one gather per feature over the unique missing ids and
        admitted."""
        bb, f, lb = idx.shape
        d = self.cfg.emb_dim
        proj = self._read("proj")
        feats = np.zeros((bb, f, d), np.float32)
        for i, mod in enumerate(self.modules):
            pooled = np.zeros((bb, mod.out_dim), np.float32)
            live = np.argwhere(mask[:, i, :] > 0)
            gids = [int(idx[b, i, l]) for b, l in live]
            keys = [self._row_key(i, g) for g in gids]
            found, missing = self.cache.get_many(keys)
            if missing:
                miss_set = set(missing)
                miss_gids = sorted({g for g, k in zip(gids, keys) if k in miss_set})
                padded = miss_gids + [miss_gids[-1]] * \
                    (max(32, _next_pow2(len(miss_gids))) - len(miss_gids))
                rows = mod.apply(self._read("tables", i), self._host(np.asarray(padded, np.int32)))
                rows = rows.to("cpu", torch.float32).numpy()
                for g, row in zip(miss_gids, rows):
                    found[self._row_key(i, g)] = row
                    self.cache.put(self._row_key(i, g), row)
            for (b, l), key in zip(live, keys):
                pooled[b] += mask[b, i, l] * found[key]
            w = None if proj is None else proj.get(str(i))
            feats[:, i, :] = pooled if w is None \
                else pooled @ w.to("cpu", torch.float32).numpy()
        return feats

    # ------------------------------------------------------------- execution

    def _dispatch(self, wave: list[RecRequest]) -> None:
        obs = self._obs
        tq = time.monotonic() if obs is not None else None
        dense, idx, mask = self._pad_wave(wave)
        t0 = time.monotonic()
        if obs is not None and obs.collisions is not None:
            # raw served ids for the measured collision mass, from the host
            # arrays this wave was padded into (made anew for every wave)
            obs.collisions.record(idx, mask, live_rows=len(wave))
        span = obs.tracer.range_begin("wave") if obs is not None and obs.tracer is not None \
            else None
        check = None
        with torch.inference_mode(), self._wave_tables():
            if self._n_shards > 1:
                logits, check, ta = self._dispatch_sharded(dense, idx, mask)
            else:
                if isinstance(self.cache, DeviceHotRowCache):
                    fast = None if self.cache.record_events \
                        else self._embed_device_fast(idx, mask)
                    if fast is not None:
                        feats, nmiss = fast
                        check = (dense, idx, mask, nmiss)
                    else:
                        feats, branch = self._embed_device(idx, mask)
                        self.cache_paths[branch] += 1
                elif self.cache is not None:
                    feats = self._host(self._embed_cached(idx, mask))
                    self.cache_paths["host"] += 1
                else:
                    feats = self._embed_fwd(self._host(idx), self._host(mask))
                ta = time.monotonic() if obs is not None else None
                logits = self._dense_fwd(self._host(dense), feats)
        self._t_first = t0 if self._t_first is None else self._t_first
        oi = None
        if obs is not None:
            tb = time.monotonic()
            waits = [tq - r.t_submit for r in wave if r.t_submit is not None]
            oi = {"tq": tq, "t0": t0, "ta": ta, "tb": tb,
                  "queue_wait": max(waits) if waits else 0.0,
                  "n": len(wave), "bb": idx.shape[0], "lb": idx.shape[2], "span": span}
            if self._c_wire is not None:
                bucket = (idx.shape[0] // self._n_shards, idx.shape[2])
                wb = self._wire_by_bucket.get(bucket)
                if wb is None:
                    from ..dist.accounting import serve_wave_wire_bytes
                    wb = int(serve_wave_wire_bytes(self.placement, *bucket)["total_bytes"])
                    self._wire_by_bucket[bucket] = wb
                self._c_wire.inc(wb)
        self._inflight.append((wave, logits, t0, check, oi))

    def _reap(self) -> list[RecRequest]:
        wave, logits, t0, check, oi = self._inflight.popleft()
        tc = time.monotonic() if oi is not None else None
        if check is not None:
            # settle the speculative probe: its miss count is ready once the
            # wave's own launches have run
            dense, idx, mask, nmiss = check
            if int(nmiss) and self._n_shards > 1:
                # a cacheable row was not resident: admit it with exact
                # accounting, then recompute from the tables (every rank saw
                # the same summed count, so every rank recomputes)
                with torch.inference_mode():
                    self._admit_cacheable(idx, mask)
                    feats = self._embed_fwd(self._local(idx), self._local(mask))
                    logits = self._sharded_dense(dense, feats)
                self.cache_paths["probe_missed"] += 1
                self.cache_paths["ingraph"] += 1
            elif int(nmiss):
                with torch.inference_mode(), self._wave_tables():
                    feats, branch = self._embed_device(idx, mask)   # exact: admit+count
                    logits = self._dense_fwd(self._host(dense), feats)
                self.cache_paths["probe_missed"] += 1
                self.cache_paths[branch] += 1
            else:
                live = mask > 0
                if self._n_shards > 1:  # only cacheable slots were probed
                    live = live & self._repl_live[None, :, None]
                self.cache.stats.hits += int(live.sum())
                self.cache_paths["fast"] += 1
        td = time.monotonic() if oi is not None else None
        logits = logits.to("cpu", torch.float32).numpy()  # waits for the device
        t1 = time.monotonic()
        self._t_last = t1
        self.wave_latencies_s.append(t1 - t0)
        self.wave_sizes.append(len(wave))
        if oi is not None:
            self._record_wave(oi, tc, td, t1)
        for b, r in enumerate(wave):  # padded rows beyond len(wave) discarded
            r.score = float(logits[b])
            r.done = True
            self.completed[r.uid] = r
        return wave

    def step(self) -> list[RecRequest]:
        """Form + dispatch one wave, reap what's due; returns finished
        requests.  ``waves`` mode reaps synchronously; continuous mode lets
        up to ``max_inflight`` waves ride asynchronous launches and only
        waits on the oldest beyond that (or drains when the queue is
        empty)."""
        wave = self._form_wave()
        if wave:
            self._dispatch(wave)
        limit = 0 if self.batching == "waves" else self.max_inflight
        done: list[RecRequest] = []
        while self._inflight and (len(self._inflight) > limit or not self._queue):
            done.extend(self._reap())
        return done

    def run_until_drained(self) -> dict[int, RecRequest]:
        while self._queue or self._inflight:
            self.step()
        return self.completed

    # ------------------------------------------------------------- metrics

    def _record_wave(self, oi: dict, tc: float, td: float, t1: float) -> None:
        """Fold one reaped wave's boundary timestamps into the registry
        (and tracer).  The five partition stages tile [t0, t1] exactly:
        probe (embed / cache-probe launches), dense (dense launches),
        inflight (the pipeline gap until reap), miss_gather (settling the
        speculative probe: recompute on miss, accounting on hit), flush
        (the wait for the device as the scores come to the host)."""
        obs = self._obs
        t0, ta, tb = oi["t0"], oi["ta"], oi["tb"]
        stages = (("queue_wait", oi["tq"] - oi["queue_wait"], oi["queue_wait"]),
                  ("pad", oi["tq"], t0 - oi["tq"]),
                  ("probe", t0, ta - t0),
                  ("dense", ta, tb - ta),
                  ("inflight", tb, tc - tb),
                  ("miss_gather", tc, td - tc),
                  ("flush", td, t1 - td))
        for name, _, dur in stages:
            self._h_stage[name].observe(dur)
        self._h_wave.observe(t1 - t0)
        self._c_req.inc(oi["n"])
        self._c_waves.inc()
        if obs.tracer is not None:
            tr = obs.tracer
            tr.range_end(oi["span"])
            tr.complete("wave", t0, t1 - t0, requests=oi["n"], batch=oi["bb"], bag=oi["lb"])
            for name, ts, dur in stages:
                tr.complete(name, ts, dur)

    def stage_summary(self) -> dict:
        """Per-stage latency summaries plus the partition check: the five
        partition stages sum to the recorded wave latency (the same clock
        reads, contiguous boundaries)."""
        if self._obs is None:
            raise RuntimeError("stage_summary() needs an Obs-enabled engine")
        out = {s: self._h_stage[s].summary() for s in STAGES}
        stage_sum = sum(out[s]["sum"] for s in STAGE_PARTITION)
        lat = self._h_wave.summary()
        out["partition"] = {
            "stage_sum_s": stage_sum,
            "latency_sum_s": lat["sum"],
            "ratio": (stage_sum / lat["sum"]) if lat["sum"] else 1.0,
        }
        return out

    def reset_metrics(self) -> None:
        """Drop timing history, branch counts and the cache's traffic
        counters (after warm-up, so p50/p99 and hit rates measure steady
        serving rather than first launches and cold fills).  Cache
        residency (``bytes_cached``) survives: the rows are still
        resident.  The registry's ``serve_*`` series reset too; bound label
        handles stay live."""
        self.wave_latencies_s = []
        self.wave_sizes = []
        self._t_first = self._t_last = None
        self.cache_paths = dict.fromkeys(_CACHE_PATHS, 0)
        self.mesh_gather_bytes = 0
        if self.cache is not None:
            self.cache.stats = CacheStats(bytes_cached=self.cache.stats.bytes_cached)
        if self._obs is not None:
            self._obs.registry.reset(prefix="serve_")

    def compile_count(self) -> dict:
        """Distinct input-shape signatures each program has run since the
        last install — the programs a per-bucket CUDA graph would capture,
        and the count the reference's per-program jit caches hold.
        ``swap_plan`` restarts the counts.  Returns ``{"per_program":
        {...}, "total": n}``."""
        per = {name: len(sigs) for name, sigs in self._signatures.items()}
        return {"per_program": per, "total": sum(per.values())}

    def metrics(self) -> dict:
        lat = np.asarray(self.wave_latencies_s or [0.0])
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        out = {
            "requests": int(sum(self.wave_sizes)),
            "waves": len(self.wave_sizes),
            "batching": self.batching,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "qps": (sum(self.wave_sizes) / wall) if wall > 0 else 0.0,
            "buckets": sorted(self.buckets_seen),
        }
        if self.mesh is not None:
            from ..dist.sharding import axis_sizes
            out["mesh"] = {"axes": axis_sizes(self.mesh), "gather_bytes": self.mesh_gather_bytes}
        if self.cache is not None:
            out["cache"] = self.cache.stats.as_dict()
            out["cache_paths"] = dict(self.cache_paths)
            if self._obs is not None:
                # fold residency + traffic into gauges at scrape time (never
                # per wave: this walk is not hot-path work)
                g = self._obs.gauge("serve_cache_stat", "hot-row cache stats at last scrape")
                for k, v in out["cache"].items():
                    g.set(float(v), stat=k)
        return out

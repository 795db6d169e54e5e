"""Shared config helpers for the port's architectures: the ``ModelApi``
adapter a config's ``api(cfg)`` returns, the ``Shape`` its batch functions
take, the training batch's structure as ``meta`` tensors (``sds``, the
reference's ``jax.ShapeDtypeStruct``), ``embedding_spec``, and the LM
family's pieces (``lm_train_batch``, ``default_optimizer``,
``default_accum``, ``lm_api``, the SSM family's ``mamba_api`` and
``hybrid_api``, and the multimodal ``encdec_api`` and ``vlm_api``).

The dry run's inputs: the assigned shape grid ``SHAPES`` and
``lowerables(api, shape_name, mesh)``, which returns the callable and its
arguments for one (arch × shape × mesh) cell, every tensor a DTensor of
``meta`` shards laid out as the reference lays out its structs
(``param_structs``, ``state_structs``, ``cache_spec``,
``_batch_like_spec``):
    train_*    → train_step(state, batch)
    prefill_*  → prefill(params, *inputs, cache)
    decode_* / long_* → decode_step(params, tokens, pos, cache)
``api`` must be built on the ``meta`` device (``mod.api(cfg, device="meta")``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Optional

import torch

from ..core import EmbeddingSpec, factory

__all__ = ["SHAPES", "Shape", "ModelApi", "embedding_spec", "resolve_plan", "sds",
           "lm_train_batch", "default_optimizer", "default_accum", "lm_api", "mamba_api",
           "hybrid_api", "encdec_api", "vlm_api", "batch_sharding", "cache_spec", "param_structs",
           "state_structs", "lowerables"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass
class ModelApi:
    name: str
    cfg: Any
    init: Callable                      # torch.Generator -> params
    loss_fn: Callable                   # (params, batch) -> (loss, metrics)
    optimizer: Any                      # repro_torch Optimizer
    train_batch: Callable               # (shape: Shape) -> batch of meta tensors
    batch_fn: Callable                  # (step, shape) -> batch of tensors
    accum: int = 1                      # gradient-accumulation microbatches
    accum_dtype: str = "float32"        # grad accumulator dtype (bf16 for 100B+)
    prefill_inputs: Optional[Callable] = None   # (shape) -> tuple of meta tensors (pre-cache)
    prefill: Optional[Callable] = None          # (params, *inputs, cache)
    make_cache: Optional[Callable] = None       # (batch, max_len) -> cache
    decode: Optional[Callable] = None           # (params, tokens, pos, cache)
    sub_quadratic: bool = False                 # may run long_500k
    predict: Optional[Callable] = None          # (params, batch) -> scores (rec)


def sds(shape, dtype) -> torch.Tensor:
    """A shape and dtype with no storage: a tensor on the ``meta`` device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def embedding_spec(embedding: str, num_collisions: int = 4) -> EmbeddingSpec:
    kind = embedding if embedding in factory.KINDS else "qr"
    return EmbeddingSpec(kind=kind, num_collisions=num_collisions, op="mult")


def resolve_plan(plan, table_sizes):
    """A ``repro_torch.plan.MemoryPlan`` (or a path to its JSON artifact,
    written by either package) ready to serve as a config's ``embedding``:
    loads if needed and validates that it was solved for exactly these
    table sizes."""
    from ..plan import MemoryPlan
    if isinstance(plan, (str, bytes, os.PathLike)):
        plan = MemoryPlan.load(plan)
    plan.validate_sizes(table_sizes)
    return plan


# ------------------------------------------------------------------ LM family


def lm_train_batch(cfg, shape: Shape):
    """The LM training batch's structure: tokens and labels int32 ``(B, S)``,
    mask f32 ``(B, S)``."""
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": sds((b, s), torch.int32), "labels": sds((b, s), torch.int32),
            "mask": sds((b, s), torch.float32)}


def default_optimizer(n_params_billion: float):
    """Adam below ~30B params; Adafactor above (state must fit HBM)."""
    from ..optim import optimizers as opt_mod
    if n_params_billion >= 30:
        return opt_mod.adafactor(1e-3)
    return opt_mod.adam(3e-4)


def default_accum(n_params_billion: float) -> int:
    """Gradient-accumulation microbatches for train_4k (batch 256)."""
    if n_params_billion >= 30:
        return 8
    if n_params_billion >= 1:
        return 2
    return 1


def _lm_family_api(cfg, n_params_billion, accum, device, *, init, loss_fn, prefill,
                   make_cache, decode, sub_quadratic, train_batch=None, prefill_inputs=None,
                   batch_fn=None) -> ModelApi:
    """An LM family's ``ModelApi`` from its model module's functions:
    parameters drawn from a ``torch.Generator`` on ``device``, caches and
    batches there.  ``train_batch``, ``prefill_inputs`` and ``batch_fn``
    default to a decoder LM's (tokens only; the port's LM stream,
    ``data.lm.batch_at(0, step)``); ``prefill`` takes the model's inputs
    before the cache."""
    from ..data import lm as lm_data
    return ModelApi(
        name=cfg.name, cfg=cfg,
        init=lambda generator: init(generator, cfg, device),
        loss_fn=lambda p, b: loss_fn(p, b, cfg),
        optimizer=default_optimizer(n_params_billion),
        accum=default_accum(n_params_billion) if accum is None else accum,
        accum_dtype="bfloat16" if n_params_billion >= 100 else "float32",
        train_batch=train_batch or (lambda shape: lm_train_batch(cfg, shape)),
        prefill_inputs=prefill_inputs or (
            lambda shape: (sds((shape.global_batch, shape.seq_len), torch.int32),)),
        prefill=lambda params, *inputs: prefill(params, *inputs, cfg),
        make_cache=lambda b, ml: make_cache(cfg, b, ml, device),
        decode=lambda params, tokens, pos, cache: decode(params, tokens, pos, cache, cfg),
        sub_quadratic=sub_quadratic,
        batch_fn=batch_fn or (lambda step, shape: lm_data.batch_at(
            0, step, shape.global_batch, shape.seq_len, cfg.vocab, device=device)))


def lm_api(cfg, n_params_billion: float, accum: int | None = None,
           device="cuda") -> ModelApi:
    """The reference's ``lm_api``, on ``device``."""
    from ..models import lm as lm_mod
    return _lm_family_api(cfg, n_params_billion, accum, device, init=lm_mod.init,
                          loss_fn=lm_mod.loss_fn, prefill=lm_mod.prefill,
                          make_cache=lm_mod.make_decode_cache, decode=lm_mod.decode_step,
                          sub_quadratic=False)


def mamba_api(cfg, n_params_billion: float, accum: int | None = None,
              device="cuda") -> ModelApi:
    """The reference's ``mamba_api`` (a pure Mamba2 stack), on ``device``
    as ``lm_api``; sub-quadratic, so it may run long_500k."""
    from ..models import hybrid as hy
    return _lm_family_api(cfg, n_params_billion, accum, device, init=hy.mamba_init,
                          loss_fn=hy.mamba_loss_fn, prefill=hy.mamba_prefill,
                          make_cache=hy.mamba_make_cache, decode=hy.mamba_decode_step,
                          sub_quadratic=True)


def hybrid_api(cfg, n_params_billion: float, accum: int | None = None,
               device="cuda") -> ModelApi:
    """The reference's ``hybrid_api`` (Mamba2 + a shared attention block),
    on ``device`` as ``lm_api``; sub-quadratic."""
    from ..models import hybrid as hy
    return _lm_family_api(cfg, n_params_billion, accum, device, init=hy.hybrid_init,
                          loss_fn=hy.hybrid_loss_fn, prefill=hy.hybrid_prefill,
                          make_cache=hy.hybrid_make_cache, decode=hy.hybrid_decode_step,
                          sub_quadratic=True)


def encdec_api(cfg, n_params_billion: float, accum: int | None = None,
               device="cuda") -> ModelApi:
    """The reference's ``encdec_api``, on ``device``: the batch and the
    prefill's inputs carry bf16 stub frames ``(B, seq_len // enc_ratio,
    d_model)`` (``data.lm.frames_at``) first."""
    from ..data import lm as lm_data
    from ..models import encdec as ed

    def train_batch(shape: Shape):
        b, s = shape.global_batch, shape.seq_len
        return {"frames": sds((b, s // cfg.enc_ratio, cfg.d_model), torch.bfloat16),
                **lm_train_batch(cfg, shape)}

    def batch_fn(step, shape: Shape):
        b = lm_data.batch_at(0, step, shape.global_batch, shape.seq_len, cfg.vocab,
                             device=device)
        b["frames"] = lm_data.frames_at(0, step, shape.global_batch,
                                        max(1, shape.seq_len // cfg.enc_ratio), cfg.d_model,
                                        device=device).to(torch.bfloat16)
        return b

    return _lm_family_api(
        cfg, n_params_billion, accum, device, init=ed.encdec_init, loss_fn=ed.encdec_loss_fn,
        prefill=ed.encdec_prefill, make_cache=ed.encdec_make_cache,
        decode=ed.encdec_decode_step, sub_quadratic=False, train_batch=train_batch,
        prefill_inputs=lambda shape: (
            sds((shape.global_batch, shape.seq_len // cfg.enc_ratio, cfg.d_model),
                torch.bfloat16),
            sds((shape.global_batch, shape.seq_len), torch.int32)),
        batch_fn=batch_fn)


def vlm_api(cfg, n_params_billion: float, accum: int | None = None,
            device="cuda") -> ModelApi:
    """The reference's ``vlm_api``, on ``device``: the batch and the
    prefill's inputs carry bf16 stub patches ``(B, n_patches, d_model)``
    (``data.lm.patches_at``) first, and the text takes the rest of
    ``seq_len``."""
    from ..data import lm as lm_data
    from ..models import vlm as vl

    def train_batch(shape: Shape):
        b, st = shape.global_batch, shape.seq_len - cfg.n_patches
        return {"patches": sds((b, cfg.n_patches, cfg.lm.d_model), torch.bfloat16),
                **lm_train_batch(cfg, Shape(shape.name, st, b, shape.kind))}

    def batch_fn(step, shape: Shape):
        st = shape.seq_len - cfg.n_patches
        b = lm_data.batch_at(0, step, shape.global_batch, st, cfg.lm.vocab, device=device)
        b["patches"] = lm_data.patches_at(0, step, shape.global_batch, cfg.n_patches,
                                          cfg.lm.d_model, device=device).to(torch.bfloat16)
        return b

    return _lm_family_api(
        cfg, n_params_billion, accum, device, init=vl.vlm_init, loss_fn=vl.vlm_loss_fn,
        prefill=vl.vlm_prefill, make_cache=vl.vlm_make_cache, decode=vl.vlm_decode_step,
        sub_quadratic=False, train_batch=train_batch,
        prefill_inputs=lambda shape: (
            sds((shape.global_batch, cfg.n_patches, cfg.lm.d_model), torch.bfloat16),
            sds((shape.global_batch, shape.seq_len - cfg.n_patches), torch.int32)),
        batch_fn=batch_fn)


# ------------------------------------------------------------------ the dry run's inputs


def batch_sharding(mesh) -> tuple[str, ...]:
    """The axes a batch dim is split over on ``mesh`` (a named
    ``DeviceMesh``, a mapping of axis sizes, an int or a process group):
    every axis but ``model``, the entry ``NamedSharding`` / ``to_placements``
    take for dim 0."""
    from ..dist.sharding import batch_axes
    return batch_axes(mesh)


def _dp(mesh):
    from ..dist.sharding import axis_sizes, batch_axes
    sizes = axis_sizes(mesh)
    dp = batch_axes(sizes)
    return sizes, dp, math.prod(sizes[a] for a in dp)


def _batch_like_spec(shape, batch, mesh) -> tuple:
    """Spec of a batch-shaped input: dim 0 over the data group ((pod,)
    data) where it divides, the rest replicated."""
    _, dp, n = _dp(mesh)
    spec = [None] * len(shape)
    if shape and shape[0] % n == 0 and shape[0] >= n:
        spec[0] = dp if len(dp) > 1 else dp[0]
    return tuple(spec)


def cache_spec(shape, batch, mesh, prefer_last: bool = False) -> tuple:
    """KV / state cache spec: stack dims unsharded, the batch dim over the
    data group, one more dim over ``model``.

    decode (default): the *largest* divisible dim takes ``model`` (usually
    the sequence: decode reads the whole cache and writes one slot); with
    the batch too small for the data group, a dim that the data group and
    ``model`` together divide takes both.

    prefill (``prefer_last``): the *last* divisible dim takes ``model``
    (the head / latent axis): prefill writes the whole sequence.
    """
    sizes, dp, dp_n = _dp(mesh)
    model_n = sizes.get("model", 1)
    spec: list = [None] * len(shape)
    try:
        bi = list(shape).index(batch)
    except ValueError:
        bi = None
    data_placed = False
    if bi is not None and shape[bi] % dp_n == 0 and shape[bi] >= dp_n:
        spec[bi] = dp if len(dp) > 1 else dp[0]
        data_placed = True
    cand = [i for i in range(len(shape)) if i != bi and spec[i] is None]
    if prefer_last:
        cand.sort(key=lambda i: -i)
    else:
        cand.sort(key=lambda i: -shape[i])
    for i in cand:
        if not data_placed and not prefer_last \
                and shape[i] % (dp_n * model_n) == 0 and shape[i] >= dp_n * model_n:
            spec[i] = tuple(dp) + ("model",)
            data_placed = True
            break
        if shape[i] % model_n == 0 and shape[i] >= model_n:
            spec[i] = "model"
            break
    return tuple(spec)


def _distributed(tree_, mesh, spec_fn):
    """Every leaf of ``tree_`` (``meta`` tensors) a DTensor laid out by
    ``spec_fn(shape)``."""
    from .. import tree
    from ..dist.sharding import NamedSharding, distribute
    return tree.unflatten(tree_, [distribute(leaf, NamedSharding(mesh, spec_fn(tuple(leaf.shape))))
                                  for leaf in tree.leaves(tree_)])


def param_structs(api: ModelApi, mesh, overrides=None):
    """The parameters as DTensors of ``meta`` shards, laid out by
    ``tree_shardings(..., overrides)``."""
    from .. import tree
    from ..dist.sharding import distribute, tree_shardings
    structs = api.init(torch.Generator().manual_seed(0))
    shardings = tree.leaves(tree_shardings(structs, mesh, overrides))
    return tree.unflatten(structs, [distribute(leaf, sh) for leaf, sh in
                                    zip(tree.leaves(structs), shardings)])


def _opt_sharding_like(pstructs, ostructs, mesh):
    """Optimizer state laid out like its parameter where the shapes allow
    (the parameter's spec, an axis dropped from a dim it does not divide);
    ``ostructs`` is parallel to the parameter leaves, a dict per leaf."""
    from .. import tree
    from ..dist.sharding import axis_sizes, spec_for
    from ..optim.optimizers import leaf_paths
    sizes = axis_sizes(mesh)
    p_specs = [spec_for(path, tuple(leaf.shape), mesh)
               for path, leaf in zip(leaf_paths(pstructs), tree.leaves(pstructs))]

    def fit(spec, shape):
        out = []
        for i, dim in enumerate(shape):
            ax = spec[i] if i < len(spec) else None
            if ax is None:
                out.append(None)
                continue
            n = math.prod(sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,)))
            out.append(ax if (dim % n == 0 and dim >= n) else None)
        return tuple(out)

    return [_distributed(leaf_state, mesh, lambda shape, spec=spec: fit(spec, shape))
            for spec, leaf_state in zip(p_specs, ostructs)]


def state_structs(api: ModelApi, mesh):
    """The full train state as DTensors of ``meta`` shards: parameters,
    optimizer state (``_opt_sharding_like``) and the int32 step."""
    pstructs = api.init(torch.Generator().manual_seed(0))
    ostructs = _opt_sharding_like(pstructs, api.optimizer.init(pstructs), mesh)
    step = _distributed(sds((), torch.int32), mesh, lambda shape: ())
    return {"params": param_structs(api, mesh), "opt": ostructs, "step": step}


def lowerables(api: ModelApi, shape_name: str, mesh):
    """(callable, ordered arguments) for one (arch × shape × mesh) cell; sets
    the data-parallel group and the model axis's size that the models'
    ``constrain`` calls read."""
    from ..dist.sharding import INFERENCE_OVERRIDES, axis_sizes, batch_axes, set_batch_shard_axes
    from ..train.loop import make_train_step
    sizes = axis_sizes(mesh)
    set_batch_shard_axes(batch_axes(sizes), model_size=sizes.get("model", 1))
    shape = SHAPES[shape_name]
    batch_spec = lambda s: _batch_like_spec(s, shape.global_batch, mesh)  # noqa: E731
    if shape.kind == "train":
        state = state_structs(api, mesh)
        batch = _distributed(api.train_batch(shape), mesh, batch_spec)
        step = make_train_step(api.loss_fn, api.optimizer, accum=api.accum,
                               accum_dtype=getattr(torch, api.accum_dtype))
        return step, (state, batch)

    params = param_structs(api, mesh, overrides=INFERENCE_OVERRIDES)
    cache = api.make_cache(shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        inputs = _distributed(tuple(api.prefill_inputs(shape)), mesh, batch_spec)
        cache = _distributed(cache, mesh, lambda s: cache_spec(s, shape.global_batch, mesh,
                                                               prefer_last=True))
        return api.prefill, (params,) + tuple(inputs) + (cache,)

    # decode: one new token with a cache of seq_len
    tokens = _distributed(sds((shape.global_batch, 1), torch.int32), mesh, batch_spec)
    cache = _distributed(cache, mesh, lambda s: cache_spec(s, shape.global_batch, mesh))
    return api.decode, (params, tokens, 0, cache)

"""Mixture-of-Experts layer with sort-based (Megablocks-style) dispatch:
the JAX package's ``nn/moe.py``, the same math on tensors.

Dispatch per token group (the tokens split into ``gcd(N, groups)``
contiguous groups; routing and capacity are decided within a group):
  1. the router in f32: softmax over the experts, top-k (the lower expert
     index first among equal probabilities, as ``lax.top_k``), the gates
     renormalised;
  2. the (token, expert) routes stably sorted by expert; each expert's
     start in the sorted order from ``searchsorted``;
  3. rank within expert = position − start; routes beyond the static
     capacity ``C = ceil(N_g·k/E · capacity_factor)`` are dropped (sent to
     a sacrificial row ``E·C`` that is never read back), so a dropped route
     contributes zero;
  4. the expert FFN (swish-gated) is one batched product per weight over
     the ``(E, G·C, D)`` buffer, in the compute dtype;
  5. the results gathered back, unsorted and gate-weighted over the k
     routes.

On DTensors (the dry run's production mesh) the layer keeps the
reference's layout: token groups over the data axes (replicated at decode
scale, the reference's ``inference`` switch), experts over ``model``.
Routing and the two scatters (argsort, searchsorted, index_put) have no
sharding strategy: they run through ``local_map`` on each rank's token
groups (``_dispatch`` / ``_combine``), the expert FFN runs on DTensors
with the buffer's experts split over ``model``, and its output is gathered
whole along the experts before the combine (where the reference's
expert→token all-to-all stands).  On plain tensors those steps are the
identity.  The products are plain ``torch.bmm`` / einsum: the reference
computes them outside any Pallas kernel.

Shared ("always-on") experts (DeepSeek-V2) and a parallel dense residual
branch (Arctic) are composed in the model layer (``models/lm.py``), not
here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as tf

from ..dist.sharding import constrain, dp_entry, is_dtensor, replicate_dim, to_placements
from .layers import dense_init

__all__ = ["MoEConfig", "Routes", "moe_init", "moe_apply", "route"]

# The router's f32 product stays true f32 on the card: no TF32 in float32
# matrix products (PyTorch's default, stated here so routing does not
# depend on another module to set it).
torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    capacity_factor: float = 1.25
    groups: int = 256          # token groups; actual = gcd(N, groups)
    renorm: bool = True        # renormalise top-k gate weights
    aux_weight: float = 0.01   # load-balance loss weight


def moe_init(generator, cfg: MoEConfig, param_dtype, device="cuda"):
    """The router (f32, for a stable softmax) and the stacked expert
    weights ``wi``, ``wg`` ``(E, D, F)`` and ``wo`` ``(E, F, D)``, drawn in
    the reference's key order (router, wi, wg, wo), each N(0, 1) in f32
    scaled by ``D^-½`` (``F^-½`` for ``wo``) and cast once."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    s_in, s_out = (1.0 / d) ** 0.5, (1.0 / f) ** 0.5

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale).to(param_dtype)

    router = dense_init(generator, d, e, torch.float32, device=device)
    wi = normal((e, d, f), s_in)
    wg = normal((e, d, f), s_in)
    return {"router": router, "wi": wi, "wg": wg, "wo": normal((e, f, d), s_out)}


class Routes(NamedTuple):
    """One group-batched routing decision: ``probs`` (G, Ng, E) f32,
    ``gate`` / ``idx`` (G, Ng, k) the renormalised top-k gates and their
    experts, ``order`` (G, Nk) the stable sort of the flat routes by
    expert, ``dest`` (G, Nk) each sorted route's buffer row (``E·C`` when
    dropped), ``starts`` (G, E) each expert's first sorted position."""
    probs: torch.Tensor
    gate: torch.Tensor
    idx: torch.Tensor
    order: torch.Tensor
    dest: torch.Tensor
    starts: torch.Tensor


def route(params, xf, cfg: MoEConfig, cap: int) -> Routes:
    """Route the grouped tokens ``xf`` (G, Ng, D) at capacity ``cap``."""
    g, ng, _ = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    nk = ng * k
    logits = torch.einsum("gnd,de->gne", xf.to(torch.float32),
                          params["router"]["w"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k puts the lower index first among equal values; torch.topk
    # promises no order for ties, a stable descending sort does
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :k], idx[..., :k]
    if cfg.renorm:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    flat_e = idx.reshape(g, nk)
    order = torch.argsort(flat_e, dim=1, stable=True)               # (G, Nk)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(e, device=xf.device).expand(g, e).contiguous()
    starts = torch.searchsorted(sorted_e, experts, right=False)     # (G, E)
    pos = torch.arange(nk, device=xf.device)[None, :] - torch.gather(starts, 1, sorted_e)
    dest = torch.where(pos < cap, sorted_e * cap + pos, e * cap)   # overflow -> row E*C
    return Routes(probs, gate, idx, order, dest, starts)


def _experts(params, ebuf, compute_dtype):
    """The swish-gated expert FFN over the ``(G, E, C, D)`` buffer: one
    batched product per weight over the E experts, ``G·C`` rows each."""
    g, e, cap, d = ebuf.shape
    xe = ebuf.permute(1, 0, 2, 3).reshape(e, g * cap, d)
    h = torch.bmm(xe, params["wi"].to(compute_dtype))
    h = h * tf.silu(torch.bmm(xe, params["wg"].to(compute_dtype)))
    eout = torch.bmm(h, params["wo"].to(compute_dtype))
    return eout.reshape(e, g, cap, d).permute(1, 0, 2, 3)


def _dispatch(xf, router_w, cfg: MoEConfig, cap: int, compute_dtype):
    """Route the groups ``xf`` (G, Ng, D) and scatter each route's token into
    the ``(G, E·C + 1, D)`` buffer (row ``E·C`` sacrificial).  Returns the
    buffer and the routing tensors ``_combine`` reads."""
    g, _, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    r = route({"router": {"w": router_w}}, xf, cfg, cap)
    rows = torch.arange(g, device=xf.device)[:, None]
    xs = xf[rows, r.order // k].to(compute_dtype)                  # (G, Nk, D)
    # every dropped route lands on the sacrificial row E*C, so that row's
    # value is whichever write lands last (nondeterministic on CUDA); it is
    # cut off below and never read, and its gradient is zero.  index_put on
    # a fresh buffer (not in place) keeps autograd through the scatter.
    buf = torch.zeros((g, e * cap + 1, d), dtype=compute_dtype, device=xf.device)
    buf = buf.index_put((rows, r.dest), xs)
    return buf, r.order, r.dest, r.gate, r.probs, r.starts


def _combine(eout, order, dest, gate, probs, starts, cfg: MoEConfig):
    """Gather the expert outputs ``eout`` (G, E, C, D) back to the routes,
    unsort, gate-weight and sum over the k routes → (G, Ng, D); and each
    group's load-balance term ``sum_e f_e · P_e`` (G,), f_e before
    capacity."""
    g, e, cap, d = eout.shape
    k = cfg.top_k
    nk = order.shape[1]
    rows = torch.arange(g, device=eout.device)[:, None]
    outb = torch.cat([eout.reshape(g, e * cap, d),
                      torch.zeros((g, 1, d), dtype=eout.dtype, device=eout.device)], dim=1)
    out_sorted = outb[rows, dest]                                   # dropped routes read 0
    out_flat = torch.zeros((g, nk, d), dtype=eout.dtype, device=eout.device)
    out_flat = out_flat.index_put((rows, order), out_sorted)        # a permutation: unique
    out = (out_flat.reshape(g, nk // k, k, d) * gate[..., None].to(eout.dtype)).sum(dim=2)
    counts = torch.diff(starts, dim=1,
                        append=torch.full((g, 1), nk, dtype=starts.dtype, device=eout.device))
    f_e = counts.to(torch.float32) / nk
    p_e = probs.mean(dim=1)
    return out, (f_e * p_e).sum(-1)


def moe_apply(params, x, cfg: MoEConfig, compute_dtype):
    """x: (B, S, D) → (out (B, S, D) in ``x``'s dtype, aux_loss f32 scalar)."""
    b, s, d = x.shape
    n = b * s
    g = math.gcd(n, cfg.groups)
    ng = n // g
    e = cfg.n_experts
    cap = max(1, int(math.ceil(ng * cfg.top_k / e * cfg.capacity_factor)))
    dp = None if n <= 4096 else "dp"   # decode-scale token counts: groups whole

    xf = constrain(x.reshape(g, ng, d), dp, None, None)
    buf, *routes = _on_groups(lambda xl, w: _dispatch(xl, w, cfg, cap, compute_dtype),
                              xf, whole=(params["router"]["w"],), n_out=6)
    ebuf = constrain(buf[:, : e * cap].reshape(g, e, cap, d), dp, "model", None, None)
    eout = replicate_dim(_experts(params, ebuf, compute_dtype), 1)
    out, balance = _on_groups(lambda el, *rl: _combine(el, *rl, cfg), eout, *routes, n_out=2)
    aux = cfg.aux_weight * e * balance.mean()
    return out.reshape(b, s, d).to(x.dtype), aux


def _on_groups(fn, grouped, *rest, whole=(), n_out: int):
    """``fn(grouped, *rest, *whole)`` with dim 0 of ``grouped``, of each of
    ``rest`` and of every output the token groups: on DTensors through
    ``local_map``, the groups split over the data axes as ``grouped`` is
    (or whole), each of ``whole`` whole on every rank (its gradient a
    pending sum over the dims that split the groups)."""
    if not is_dtensor(grouped):
        return fn(grouped, *rest, *whole)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = grouped.device_mesh
    split = any(getattr(p, "dim", None) == 0 for p in grouped.placements)
    group_pl = list(to_placements((dp_entry(mesh, grouped.shape[0]) if split else None,), mesh))
    whole_pl = [Replicate()] * mesh.ndim
    share_pl = [Replicate() if isinstance(p, Replicate) else Partial() for p in group_pl]
    return local_map(fn, out_placements=tuple([group_pl] * n_out),
                     in_placements=(group_pl,) * (1 + len(rest)) + (whole_pl,) * len(whole),
                     in_grad_placements=(group_pl,) * (1 + len(rest)) + (share_pl,) * len(whole),
                     device_mesh=mesh, redistribute_inputs=True)(grouped, *rest, *whole)

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

The reference's ``constrain(...)`` calls and its ``inference`` switch are
sharding annotations only: on one device they are the identity, and the
port has no ``constrain`` until the DTensor mapping (ROADMAP item 18c), so
they are left out here.  The products are plain ``torch.bmm`` / einsum:
the reference computes them outside any Pallas kernel.

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


def moe_apply(params, x, cfg: MoEConfig, compute_dtype):
    """x: (B, S, D) → (out (B, S, D) in ``x``'s dtype, aux_loss f32 scalar)."""
    b, s, d = x.shape
    n = b * s
    g = math.gcd(n, cfg.groups)
    ng = n // g
    e, k = cfg.n_experts, cfg.top_k
    nk = ng * k
    cap = max(1, int(math.ceil(nk / e * cfg.capacity_factor)))

    xf = x.reshape(g, ng, d)
    r = route(params, xf, cfg, cap)
    rows = torch.arange(g, device=x.device)[:, None]
    xs = xf[rows, r.order // k].to(compute_dtype)                  # (G, Nk, D)
    # every dropped route lands on the sacrificial row E*C, so that row's
    # value is whichever write lands last (nondeterministic on CUDA); it is
    # cut off below and never read, and its gradient is zero.  index_put on
    # a fresh buffer (not in place) keeps autograd through the scatter.
    buf = torch.zeros((g, e * cap + 1, d), dtype=compute_dtype, device=x.device)
    buf = buf.index_put((rows, r.dest), xs)
    eout = _experts(params, buf[:, : e * cap].reshape(g, e, cap, d), compute_dtype)

    outb = torch.cat([eout.reshape(g, e * cap, d),
                      torch.zeros((g, 1, d), dtype=compute_dtype, device=x.device)], dim=1)
    out_sorted = outb[rows, r.dest]                                 # dropped routes read 0
    out_flat = torch.zeros((g, nk, d), dtype=compute_dtype, device=x.device)
    out_flat = out_flat.index_put((rows, r.order), out_sorted)      # a permutation: unique
    out = (out_flat.reshape(g, ng, k, d) * r.gate[..., None].to(compute_dtype)).sum(dim=2)

    # Switch-style load-balance aux: E * <f_e * P_e>, f_e before capacity
    counts = torch.diff(r.starts, dim=1,
                        append=torch.full((g, 1), nk, dtype=r.starts.dtype, device=x.device))
    f_e = counts.to(torch.float32) / nk
    p_e = r.probs.mean(dim=1)
    aux = cfg.aux_weight * e * (f_e * p_e).sum(-1).mean()
    return out.reshape(b, s, d).to(x.dtype), aux

"""Mixture-of-Experts MLP: two dispatch implementations, one weight set.

Port of ``repro/models/moe.py`` for one device.

* ``capacity`` (default): the ``T·K`` (token, choice) rows sorted by expert
  (a **stable** sort, so within an expert the rows stay in token order) and
  packed into an ``(E, cap, D)`` buffer; the expert FFNs run as batched
  GEMMs (``torch.bmm``, as the reference's ``einsum("ecd,edf->ecf")``
  outside any Pallas kernel); rows past ``cap`` in an expert are dropped,
  the last ones first.  The activation between the GEMMs is kernel 2a's
  ``gated`` site function over the packed rows.
* ``ragged``: dropless; the sorted rows go through :func:`grouped_matmul`,
  a per-expert loop over the groups (one device-to-host copy of the group
  sizes a layer).  The oracle of the capacity path.
* ``a2a``: all-to-all expert parallelism.  Without a mesh the reference's
  version is :func:`moe_mlp`, and so is the port's.

Routing is softmax + top-k in float32, renormalised (``router_scale``).
The combine needs no atomics: the (token, choice) rows come back in row
order (``tok = arange(T·K) // K``), so the reference's scatter-add over
``tok`` is a weighted sum over the K choices of a ``(T, K, D)`` view.  The
mesh branches (expert-TP under ``shard_map``, the all-to-alls) wait for
sharded execution (ROADMAP A7.7); the port's ``ExecContext`` has no mesh.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .config import ModelConfig
from .context import ExecContext


# ---------------------------------------------------------------------------
# grouped GEMM (the ragged path)
# ---------------------------------------------------------------------------

def grouped_matmul(xs, w, gs):
    """xs (T, D) sorted by expert; w (E, D, F); gs (E,) group sizes (a
    tensor or a list of ints) → (T, F): rows of group e times ``w[e]``,
    rows past ``sum(gs)`` zero (``lax.ragged_dot``'s semantics).  Autograd
    differentiates the loop, so it needs no custom backward."""
    sizes = gs.tolist() if torch.is_tensor(gs) else [int(g) for g in gs]
    total = sum(sizes)
    outs = [part @ w[e] for e, part in enumerate(torch.split(xs[:total], sizes))]
    if total < xs.shape[0]:
        outs.append(xs.new_zeros(xs.shape[0] - total, w.shape[-1]))
    return torch.cat(outs, 0)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _route(x2, router_w, moe):
    """tokens (T, D) → (weights (T, K), experts (T, K) int32, router probs
    (T, E)), all in float32."""
    logits = x2.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, moe.top_k, dim=-1)
    if moe.router_scale:
        top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return top_w, top_e.to(torch.int32), probs


def _act(up, gate, cfg: ModelConfig, ctx: ExecContext):
    if gate is not None:
        return ops.gated_act(gate, up, kind=cfg.act, target=ctx.backend,
                             vvl=ctx.vvl, device=up.device)
    return ops.gated_act(up, None, kind=cfg.act, target=ctx.backend,
                         vvl=ctx.vvl, device=up.device)


# ---------------------------------------------------------------------------
# capacity-packed batched-GEMM expert application
# ---------------------------------------------------------------------------

def _apply_experts_capacity(xs, e_ids, valid, p, cfg: ModelConfig,
                            ctx: ExecContext, cap: int):
    """Run rows ``xs (N, D)`` through experts ``e_ids (N,)``.

    Rows with ``valid=False``, and rows beyond ``cap`` in an expert, return
    zero contributions.  Slot ``(e, c)`` of the pack holds the ``c``-th
    kept row of expert ``e`` in sorted order, so the pack is a gather (no
    scatter: the reference's add of the dropped rows' zeros into slot
    ``cap-1`` changes nothing there), and each kept row reads its result
    back from its own slot."""
    e = p["w_up"].shape[0]
    n, d = xs.shape
    fe = p["w_up"].shape[-1]
    dev = xs.device

    key = torch.where(valid, e_ids.long(), e)          # invalid rows sort last
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    es = key_s.clamp(0, e - 1)
    experts = torch.arange(e, device=dev)
    seg_start = torch.searchsorted(key_s, experts, side="left")
    seg_end = torch.searchsorted(key_s, experts, side="right")
    pos = torch.arange(n, device=dev) - seg_start[es]
    keep = valid[order] & (pos < cap)
    slot = torch.where(keep, pos, cap - 1)

    src = seg_start[:, None] + torch.arange(cap, device=dev)   # (E, cap)
    live = src < seg_end[:, None]
    rows = order[src.clamp(max=n - 1)]
    buf = torch.where(live[..., None], xs[rows], 0.0)          # (E, cap, D)

    up = torch.bmm(buf, p["w_up"])
    gate = torch.bmm(buf, p["w_gate"]) if "w_gate" in p else None
    h2 = _act(up.reshape(e * cap, fe),
              None if gate is None else gate.reshape(e * cap, fe), cfg, ctx)
    down = torch.bmm(h2.reshape(e, cap, fe), p["w_down"])       # (E, cap, D)

    contrib_sorted = torch.where(keep[:, None],
                                 down.reshape(e * cap, d)[es * cap + slot], 0.0)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    return contrib_sorted[inv]                                 # row order of xs


def _combine(contrib, w_flat, t: int, k: int, dtype):
    """The reference's float32 ``out.at[tok].add(contrib · w)`` with ``tok
    = arange(T·K) // K``: a weighted sum over the K choices."""
    d = contrib.shape[-1]
    out = (contrib.float().reshape(t, k, d)
           * w_flat.float().reshape(t, k, 1)).sum(1)
    return out.to(dtype)


def capacity(t: int, moe) -> int:
    """Slots per expert of the capacity path for ``t`` tokens: ``cf =
    capacity_factor or 1.25`` (a factor of 0 runs at 1.25 here, as in the
    reference's code), at least 8 (single-token decode would otherwise
    round to one slot and drop colliding choices), at most ``t·k``."""
    k, e = moe.top_k, moe.num_experts
    cf = moe.capacity_factor or 1.25
    return min(t * k, max(int(-(-t * k * cf // e)), 8))


def _expert_ffn_local(x2, top_w, top_e, p, cfg: ModelConfig,
                      ctx: ExecContext):
    """Expert FFN on ``x2 (T, D)`` with all experts; returns (T, D)."""
    moe = cfg.moe
    t, d = x2.shape
    k, e = moe.top_k, moe.num_experts
    flat_e = top_e.reshape(-1).long()                      # (T·K,)
    w_flat = top_w.reshape(-1)

    if ctx.moe_impl == "ragged":
        order = torch.argsort(flat_e, stable=True)
        xs = x2[order // k]                                # (T·K, D)
        gs = torch.bincount(flat_e, minlength=e).tolist()  # one sync a layer
        up = grouped_matmul(xs, p["w_up"], gs)
        gate = grouped_matmul(xs, p["w_gate"], gs) if "w_gate" in p else None
        down = grouped_matmul(_act(up, gate, cfg, ctx), p["w_down"], gs)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(t * k, device=x2.device)
        return _combine(down[inv], w_flat, t, k, x2.dtype)

    xs = x2.repeat_interleave(k, dim=0)                    # (T·K, D)
    contrib = _apply_experts_capacity(
        xs, flat_e, torch.ones(t * k, dtype=torch.bool, device=x2.device), p,
        cfg, ctx, capacity(t, moe))
    return _combine(contrib, w_flat, t, k, x2.dtype)


def _shared_ffn(p, x2, cfg: ModelConfig, ctx: ExecContext):
    up = x2 @ p["w_up"]
    gate = x2 @ p["w_gate"] if "w_gate" in p else None
    return _act(up, gate, cfg, ctx) @ p["w_down"]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def moe_mlp(p, x, cfg: ModelConfig, ctx: ExecContext):
    """MoE MLP over ``x: (B, S, D)``: route, the experts, the shared
    experts (deepseek) added."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    top_w, top_e, _ = _route(x2, p["router"], cfg.moe)
    out = _expert_ffn_local(x2, top_w, top_e, p, cfg, ctx)
    if "shared" in p:
        out = out + _shared_ffn(p["shared"], x2, cfg, ctx)
    return out.reshape(b, s, d)


def moe_a2a(p, x, cfg: ModelConfig, ctx: ExecContext):
    """All-to-all expert parallelism.  Without a mesh (the port has none
    yet, ROADMAP A7.7) the reference's version is :func:`moe_mlp`, and so
    is this one."""
    return moe_mlp(p, x, cfg, ctx)

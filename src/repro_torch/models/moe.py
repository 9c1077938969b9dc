"""Mixture-of-Experts FFN: GShard-style grouped capacity dispatch, and a
dropless routing over a model's share of the experts.

The port's counterpart of ``repro/models/moe.py``: top-k routing with a
capacity bound per group of ``group_size`` tokens (dropped tokens pass
through the residual), and the Switch aux load-balancing loss
E·Σ_e f_e·p_e over the pre-capacity router distribution.  The reference
computes all of it outside any Pallas kernel, so it is plain torch here.

Routing follows the reference bit for bit:
  * router logits and softmax in float32;
  * the top k by a stable descending sort: values in descending order,
    ties toward the lower expert index, as ``jax.lax.top_k`` breaks them
    (``torch.topk`` promises no order among equal values, and the order of
    the k choices decides who gets a slot);
  * slots taken k-choice-major, then in token order;
  * the gate weights rounded to bfloat16 before the combine, as the
    reference builds its combine tensor in bfloat16 in every model dtype.

The reference dispatches through one-hot (G, g, E, C) tensors and einsums.
A token picks each expert at most once among its top k, so every (token,
expert, slot) entry of those tensors has at most one nonzero term: the
port scatters the kept tokens into their (expert, slot) rows and gathers
the experts' outputs back, with the same values and no (G, g, k, E, C)
transient (85 M entries at olmoe's 2048-token prefill).

``moe_dropless`` is jamba's routing: the float32 softmax's top k taken as
they are (not renormalised), every choice computed, no capacity.  The layer
may hold a share of the experts, ``held = (first, count)`` of the router's
outputs, as a card of an expert-parallel deployment holds its own: it
routes over all of them and adds the part of the result its experts give
(the exchange with the cards that hold the rest is not run).  A prefill
computes only the rows routed to held experts, their counts read on the
host to split them; a decode step has static shapes and reads nothing on
the host: every held expert runs on every token, weighted by the token's
gate for it (0 where it did not choose it), so the step can be one CUDA
graph.  ``counts`` (E,) int64, where given, gains each expert's choices on
the device, held or not.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .layers import _act, constrain

__all__ = ["Routing", "route", "moe_ffn", "moe_dropless"]


def _top(probs: torch.Tensor, k: int):
    """The ``k`` largest of ``probs`` (last dim) and their experts, best
    first, ties toward the lower index (``jax.lax.top_k``'s order)."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k]


class Routing(NamedTuple):
    """One call's routing, per (group, token, choice) unless noted."""

    expert: torch.Tensor  # (G, g, k) int64: the chosen experts, best first
    gate: torch.Tensor  # (G, g, k) float32: renormalised top-k probabilities
    slot: torch.Tensor  # (G, g, k) int64: position in the expert's queue
    keep: torch.Tensor  # (G, g, k) bool: slot < capacity
    capacity: int  # slots per expert and group
    aux: torch.Tensor  # () float32: the Switch load-balancing loss


def route(xt: torch.Tensor, router: torch.Tensor, *, top_k: int,
          capacity_factor: float) -> Routing:
    """Route grouped tokens ``xt`` (G, g, D) through ``router`` (D, E)."""
    n_groups, g, _ = xt.shape
    E = router.shape[-1]
    logits = torch.einsum("gsd,de->gse", xt.float(), router.float())
    probs = torch.softmax(logits, dim=-1)  # (G, g, E)
    gate, expert = _top(probs, top_k)
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)

    # aux loss on the pre-capacity distribution (Switch/GShard)
    me = probs.mean(dim=(0, 1))
    ce = torch.nn.functional.one_hot(expert[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)

    # priority: k-choice-major, then token order (GShard convention).  A
    # choice's slot is the count of earlier choices of its expert: its rank
    # in a stable sort by expert, less where the expert's run starts (the
    # reference's cumsum over a one-hot (G, g·k, E), without the one-hot)
    cap = int(g * top_k / E * capacity_factor) + 1
    flat = expert.transpose(1, 2).reshape(n_groups, top_k * g)
    order = torch.sort(flat, dim=1, stable=True).indices
    counts = torch.zeros((n_groups, E), dtype=flat.dtype, device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    starts = counts.cumsum(dim=1) - counts
    rank = torch.arange(top_k * g, device=flat.device).expand_as(flat) \
        - starts.gather(1, flat.gather(1, order))
    slot = torch.empty_like(flat).scatter_(1, order, rank)
    slot = slot.reshape(n_groups, top_k, g).transpose(1, 2)
    return Routing(expert, gate, slot, slot < cap, cap, aux)


def _constrain_gec(t, rules, kind: str, n_groups: int, cap: int):
    """Constrain the expert-major (E, G·C, ·) buffer ``t`` as the
    reference's (G, E, C, ·) tensor of activation ``kind``; returns ``t``."""
    if rules is not None:
        e, _, d = t.shape
        constrain(t.view(e, n_groups, cap, d).transpose(0, 1), rules, kind)
    return t


def moe_ffn(
    x: torch.Tensor,  # (B, S, D)
    p,  # params: router (D,E), w_gate/w_up (E,D,Fe), w_down (E,Fe,D)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    group_size: int = 512,
    act: str = "silu",
    gated: bool = True,
    rules=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(out (B, S, D) in x's dtype, aux loss float32 scalar)``.

    Raises ValueError where S is longer than ``group_size`` and not a
    multiple of it (the reference asserts): padding would change each
    group's capacity and which tokens are dropped."""
    B, S, D = x.shape
    E = p["router"].shape[-1]
    g = min(group_size, S)
    if S % g:
        raise ValueError(f"a sequence of {S} tokens does not divide into "
                         f"router groups of {g}")
    n_groups = B * (S // g)
    xt = x.reshape(n_groups, g, D)
    r = route(xt, p["router"], top_k=top_k, capacity_factor=capacity_factor)
    cap = r.capacity

    # dispatch: each kept (token, choice) fills row (expert, group, slot) of
    # a flat buffer; rows no token reached stay zero, as the one-hot einsum
    # leaves them.  Dropped choices all land on one spare last row, so no
    # mask selection (and no wait for the device) is needed.
    grp = torch.arange(n_groups, device=x.device)[:, None, None]
    rows_at = (r.expert * n_groups + grp) * cap + r.slot.clamp(max=cap - 1)
    spare = E * n_groups * cap
    buf = x.new_zeros((spare + 1, D))
    buf[torch.where(r.keep, rows_at, spare)] = \
        xt[:, :, None, :].expand(-1, -1, top_k, -1)
    ein = _constrain_gec(buf[:spare].view(E, n_groups * cap, D), rules,
                         "gecd", n_groups, cap)

    if gated:
        h = _act(torch.bmm(ein, p["w_gate"]), act) * torch.bmm(ein, p["w_up"])
    else:
        h = _act(torch.bmm(ein, p["w_up"]), act)
    h = _constrain_gec(h, rules, "gecf", n_groups, cap)
    out_e = torch.bmm(h, p["w_down"]).reshape(spare, D)

    # combine: the kept choices' rows weighted by the bf16-rounded gates,
    # one product a token accumulated in float32 as the reference's einsum
    # (a dropped choice adds zero)
    rows = torch.where(r.keep[..., None], out_e[rows_at], 0.0)
    w = r.gate.to(torch.bfloat16).to(rows.dtype)
    out = torch.bmm(w.reshape(-1, 1, top_k), rows.reshape(-1, top_k, D))
    return out.reshape(B, S, D).to(x.dtype), r.aux


def _expert(x, p, e: int, act: str, gated: bool):
    """Expert ``e``'s FFN over the rows ``x`` (n, D)."""
    if gated:
        h = _act(x @ p["w_gate"][e], act) * (x @ p["w_up"][e])
    else:
        h = _act(x @ p["w_up"][e], act)
    return h @ p["w_down"][e]


def moe_dropless(
    x: torch.Tensor,  # (B, S, D)
    p,  # router (D, E); w_gate/w_up (H, D, Fe), w_down (H, Fe, D): held
    *,
    top_k: int,
    held: Tuple[int, int],
    static: bool = False,
    counts: Optional[torch.Tensor] = None,
    act: str = "silu",
    gated: bool = True,
) -> Tuple[torch.Tensor, Optional[int]]:
    """Returns ``(out (B, S, D) in x's dtype, rows)``: the held experts'
    part of the layer, and the routed rows they computed (None in the
    ``static`` form, which runs every held expert on every token)."""
    B, S, D = x.shape
    first, n_held = held
    xt = x.reshape(B * S, D)
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    gate, expert = _top(probs, top_k)  # (T, k)
    if counts is not None:
        counts.index_add_(0, expert.reshape(-1),
                          torch.ones_like(expert.reshape(-1)))
    local = expert - first
    mine = (local >= 0) & (local < n_held)
    if static:
        w = torch.zeros((B * S, n_held), dtype=torch.float32, device=x.device)
        w.scatter_add_(1, local.clamp(0, n_held - 1), torch.where(mine, gate, 0.0))
        ein = xt.expand(n_held, -1, -1)
        if gated:
            h = _act(torch.bmm(ein, p["w_gate"]), act) * torch.bmm(ein, p["w_up"])
        else:
            h = _act(torch.bmm(ein, p["w_up"]), act)
        y = torch.bmm(h, p["w_down"])  # (H, T, D)
        out = torch.einsum("th,htd->td", w, y.float())
        return out.reshape(B, S, D).to(x.dtype), None
    # the choices grouped by held expert, the others last: the counts (one
    # read on the host) split the rows
    key = torch.where(mine, local, n_held).reshape(-1)
    order = torch.sort(key, stable=True).indices
    sizes = torch.bincount(key, minlength=n_held + 1).tolist()[:n_held]
    sel = order[:sum(sizes)]
    tok = sel // top_k
    rows = xt[tok]
    out = torch.zeros((B * S, D), dtype=torch.float32, device=x.device)
    ys, at = [], 0
    for e, n in enumerate(sizes):
        if n:
            ys.append(_expert(rows[at:at + n], p, e, act, gated))
        at += n
    if ys:
        y = torch.cat(ys).float() * gate.reshape(-1)[sel][:, None]
        out.index_add_(0, tok, y)
    return out.reshape(B, S, D).to(x.dtype), sum(sizes)

"""Model assembly: one Model class for the families the port runs.

The port's counterpart of ``repro/models/model.py`` for every family:
``dense``, ``moe``, ``ssm``, ``hybrid``, ``vlm`` (gated cross-attention
superblocks over a patch memory) and ``encdec`` (a bidirectional encoder
over a frame memory, a decoder with self and cross attention, LayerNorm).

Execution paths:
  * ``forward``      — full-sequence logits (training / eval) and the MoE
                       aux loss summed over the layers; ``loss_fn`` is the
                       mean cross entropy plus ``router_aux_weight`` × aux.
  * ``prefill``      — full sequence, returns last-position logits, cache
                       and the cross-attention K/V stack (``vlm`` and
                       ``encdec``: computed once from ``memory``, reused by
                       every decode step; None in the other families).
  * ``decode_step``  — one token against a cache (serving inner loop).

Every entry point takes ``rules`` (``distributed.sharding.ShardingRules``)
and constrains the activations at the reference's points, Ulysses branch
included; on the port's single-controller mesh a constraint checks its
guarded spec and moves nothing, so results do not depend on ``rules``.

Params keep the reference's stacked layout: each superblock leaf has a
leading layer axis, and depth is a Python loop over it (the reference's
``lax.scan``), so conversion stays one to one.  Each stacked leaf is
split into its layers once a forward (``_layers``), so where a gradient
is recorded the backward gathers its layers' gradients with one stack,
as the scan's does.  Caches are stacked the same way.  With ``remat``
(the reference's ``jax.checkpoint`` with ``nothing_saveable`` around
each superblock) each block of the stack runs
under ``torch.utils.checkpoint``: its activations are recomputed in the
backward and only its input is kept.  Where the reference returns a new
cache, the port writes the new state into the cache it was given, in
place, and returns it: a full width mamba state is 134 MB a step that
need not be copied.

Attention caches:
  * dense / moe / enc-dec / vlm self-attn — linear cache (B, Tmax, Hkv,
    hd), written at ``index``; the start is clamped as
    ``dynamic_update_slice`` clamps it.  Cross-attention blocks hold no
    cache: their K/V is the prefill's ``cross_stack``.
  * hybrid local-attn — RING cache of size ``window`` with per-slot
    positions (stale slots overwritten; masking uses stored positions);
    a hybrid without a window (jamba) keeps the linear cache.
  * mamba / rglru — O(1) recurrent state (conv tail + ssm/lru state).

Block kinds: ``attn`` (attention + MLP), ``moe`` (attention + MoE),
``mamba`` (the mixer alone), ``mamba_mlp`` / ``mamba_moe`` (the mixer, then
an MLP or MoE FFN: jamba), ``rglru`` (RG-LRU + MLP), ``cross``.  Each MoE
layer call outside a CUDA graph is a span ``model.moe`` (``layer``,
``tokens``; ``rows``, the routed rows a dropless prefill computed).  A
dropless MoE counts each expert's routed choices on the device
(:meth:`Model.routed_choices`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.common import resolve_device
from ..runtime import trace
from .config import ModelConfig
from .layers import (attention, constrain, layer_norm, mlp, rms_norm, rope,
                     softmax_cross_entropy)
from .moe import moe_dropless, moe_ffn
from .params import PORTED_FAMILIES, init_params, param_specs
from .rglru import rglru_decode_step, rglru_seq
from .ssm import mamba_decode_step, mamba_seq

__all__ = ["Model"]


def _index(tree, i: int):
    """Layer ``i`` of a stacked param or cache tree (views, not copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


class _Unbind(torch.autograd.Function):
    """``torch.unbind(stack, 0)`` whose backward stacks the layers'
    gradients into one contiguous tensor: the layout (and so the values of
    any sum over it) that adding per-layer gradients gives, where
    ``unbind``'s own backward may take a layer gradient's layout."""

    @staticmethod
    def forward(ctx, stack):
        ctx.shape = stack.shape
        return stack.unbind(0)

    @staticmethod
    def backward(ctx, *grads):
        return torch.stack(grads, out=grads[0].new_empty(ctx.shape))


def _layers(tree, n: int):
    """The first ``n`` layers of a stacked param or activation tree, a list
    of per-layer trees of views, each leaf split once (:class:`_Unbind`).
    Where the leaf records a gradient, the backward stacks the layers'
    gradients into one, where a view per layer would zero-fill and add one
    stack-sized gradient per layer; elsewhere no node is recorded and the
    views are those that indexing gives."""
    if isinstance(tree, dict):
        subs = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: s[i] for k, s in subs.items()} for i in range(n)]
    return _Unbind.apply(tree)[:n]


def _write(dst: Dict, src: Dict) -> None:
    """Copy a block's new state into its cache views (in place)."""
    for k, v in src.items():
        if v is not dst[k]:
            dst[k].copy_(v)


def _take(table, ids):
    """Rows of ``table`` as ``jnp.take`` gives them: a negative id counts
    from the end, an id past either end reads NaN."""
    n = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    inside = (ids >= 0) & (ids < n)
    return torch.where(inside[..., None], table[ids.clamp(0, n - 1)], torch.nan)


def _device_key(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _norm(cfg, x, p, name):
    if cfg.family == "encdec":
        return layer_norm(x, p[f"{name}_scale"], p[f"{name}_bias"], cfg.norm_eps)
    return rms_norm(x, p[f"{name}_scale"], cfg.norm_eps)


def _gated(out, gate, dtype):
    """``out`` × tanh(gate) in float32, cast to ``dtype``, as the
    reference's float32 gate promotes the product (torch types a bfloat16
    × 0-dim float32 product bfloat16)."""
    return (out.float() * torch.tanh(gate)).to(dtype)


class Model:
    def __init__(self, cfg: ModelConfig, *, scan_impl: Optional[str] = None):
        """``scan_impl`` picks the linear scan of the recurrent blocks
        (``kernels/linear_scan/ops.py``): None runs K5 on the card."""
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; the port runs "
                             f"{', '.join(PORTED_FAMILIES)}")
        if cfg.held_experts is not None and cfg.moe_routing != "dropless":
            raise ValueError("a share of the experts is held only under "
                             "dropless routing")
        self.cfg = cfg
        self.scan_impl = scan_impl
        self._routed: Dict[torch.device, torch.Tensor] = {}

    def init(self, generator=0, device=None):
        """Random params on ``device`` (the card unless ``"cpu"`` is asked;
        ``"meta"`` gives shape-only leaves)."""
        return init_params(self.cfg, generator, device)

    def specs(self):
        return param_specs(self.cfg)

    # =========================================================================
    # attention building blocks (single layer; leading L stripped)
    # =========================================================================
    def _project_qkv(self, p, h):
        cfg = self.cfg
        q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
        k = torch.einsum("btd,dhk->bthk", h, p["wk"])
        v = torch.einsum("btd,dhk->bthk", h, p["wv"])
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        return q, k, v

    def _self_attn(self, p, h, positions, *, cache=None, index=None,
                   causal=True, window=None, rules=None, impl="auto"):
        """Returns the attention output; writes ``cache`` in place."""
        cfg = self.cfg
        q, k, v = self._project_qkv(p, h)
        q = constrain(q, rules, "bshk")
        k = constrain(k, rules, "btkk")
        v = constrain(v, rules, "btkk")
        if cfg.family != "encdec" and cfg.use_rope:  # whisper: position tables
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        b, s = k.shape[0], k.shape[1]

        k_pos = positions
        if cache is not None and "slot_pos" in cache:
            # ring cache (windowed local attention)
            ck, cv, cp = cache["k"], cache["v"], cache["slot_pos"]
            w = ck.shape[1]
            if s > w:  # prefill longer than the window: keep the last w
                k_w, v_w, pos_w = k[:, -w:], v[:, -w:], positions[:, -w:]
            else:
                k_w, v_w, pos_w = k, v, positions
            rows = torch.arange(b, device=k.device)[:, None]
            slots = pos_w % w
            ck[rows, slots] = k_w.to(ck.dtype)
            cv[rows, slots] = v_w.to(cv.dtype)
            cp[rows, slots] = pos_w.to(cp.dtype)
            if h.shape[1] == 1:  # decode reads from the ring
                k, v, k_pos = ck, cv, cp
            # prefill: attend over the in-flight full k/v (already causal+win)
        elif cache is not None:
            # linear cache: prefill writes a block at scalar `index`; decode
            # (S == 1) writes per-batch rows at a (B,) index vector so
            # continuous batching can hold slots at different depths.
            ck, cv = cache["k"], cache["v"]
            t = ck.shape[1]
            if s == 1 and torch.is_tensor(index) and index.ndim == 1:
                at = index.clamp(0, t - 1)
                rows = torch.arange(b, device=k.device)
                ck[rows, at] = k[:, 0].to(ck.dtype)
                cv[rows, at] = v[:, 0].to(cv.dtype)
            else:
                start = min(max(int(index), 0), t - s)
                ck[:, start:start + s] = k.to(ck.dtype)
                cv[:, start:start + s] = v.to(cv.dtype)
            k, v = ck, cv
            if k.dtype != cfg.dtype:  # low-precision cache
                k, v = k.to(cfg.dtype), v.to(cfg.dtype)
            k_pos = torch.arange(t, device=k.device).expand(b, t)
            k = constrain(k, rules, "btkk")
            v = constrain(v, rules, "btkk")

        # Ulysses-style context parallelism for headdim-sharded archs
        # (head counts not divisible by the model axis): queries go from
        # hd-sharded to seq-sharded/full-head layout so the softmax needs
        # no partial-sum all-reduce; k/v gather fully.  Decode (S == 1)
        # keeps the psum path.
        ulysses = (rules is not None and rules.attn_shard == "headdim"
                   and q.shape[1] > 1)
        if ulysses:
            q = constrain(q, rules, "bshk_seq")
            k = constrain(k, rules, "btkk_full")
            v = constrain(v, rules, "btkk_full")
        out = attention(q, k, v, q_positions=positions, k_positions=k_pos,
                        causal=causal, window=window, impl=impl, rules=rules)
        if ulysses:
            out = constrain(out, rules, "bshk_seq")
        out = constrain(out, rules, "bshk")
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])

    def _cross_attn(self, p, h, cross_kv, rules=None, impl="auto"):
        """Queries from ``h`` against one layer's precomputed memory K/V,
        unmasked (the reference passes all-zero positions)."""
        q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
        if self.cfg.qkv_bias:
            q = q + p["bq"]
        k, v = cross_kv["k"], cross_kv["v"]
        b, s, t = h.shape[0], h.shape[1], k.shape[1]
        zeros = torch.zeros((), dtype=torch.long, device=h.device)
        out = attention(q, k, v, q_positions=zeros.expand(b, s),
                        k_positions=zeros.expand(b, t), causal=False,
                        impl=impl, rules=rules)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])

    def _mlp_res(self, p, x, rules, gate=None):
        cfg = self.cfg
        h = _norm(cfg, x, p, "ln2")
        out = mlp(h, p["mlp"], gated=cfg.gated_mlp, act=cfg.act, rules=rules)
        if gate is not None:
            out = _gated(out, gate, x.dtype)
        return x + constrain(out, rules, "btd")

    # =========================================================================
    # one block of a given kind
    # =========================================================================
    def _apply_block(self, kind, p, x, positions, *, cache=None, index=None,
                     cross_kv=None, rules=None, impl="auto", decode=False,
                     layer=None):
        """Returns ``(x, new recurrent state or None, MoE aux loss or None)``."""
        cfg = self.cfg
        h = _norm(cfg, x, p, "ln1")
        if kind == "cross":
            out = self._cross_attn(p["attn"], h, cross_kv, rules=rules,
                                   impl=impl)
            gated = _gated(out, p["attn"]["gate_attn"], x.dtype)
            x = x + constrain(gated, rules, "btd")
            return self._mlp_res(p, x, rules, gate=p["gate_mlp"]), None, None
        if kind in ("attn", "moe"):
            window = cfg.window if cfg.family == "hybrid" else None
            out = self._self_attn(p["attn"], h, positions, cache=cache,
                                  index=index, window=window, rules=rules,
                                  impl=impl)
            x = x + constrain(out, rules, "btd")
            if kind == "attn":
                return self._mlp_res(p, x, rules), None, None
            x, aux = self._moe_res(p, x, rules, layer, decode)
            return x, None, aux
        if kind in ("mamba", "mamba_mlp", "mamba_moe"):
            seq, step, mixer = mamba_seq, mamba_decode_step, "mamba"
        elif kind == "rglru":
            seq, step, mixer = rglru_seq, rglru_decode_step, "rglru"
        else:
            raise ValueError(kind)
        new_state = None
        if decode:
            out, new_state = step(h[:, 0], p[mixer], cfg, cache, rules=rules)
            out = out[:, None]
        elif cache is not None:  # prefill: also emit the decode state
            out, new_state = seq(h, p[mixer], cfg, rules=rules,
                                 scan_impl=self.scan_impl, return_cache=True)
        else:
            out = seq(h, p[mixer], cfg, rules=rules, scan_impl=self.scan_impl)
        x = x + constrain(out, rules, "btd")
        if kind == "mamba_moe":
            x, aux = self._moe_res(p, x, rules, layer, decode)
            return x, new_state, aux
        if kind in ("rglru", "mamba_mlp"):
            x = self._mlp_res(p, x, rules)
        return x, new_state, None

    def _moe_res(self, p, x, rules, layer, decode):
        """``x`` plus its MoE FFN: ``(x, aux loss or None)``; ``decode``
        runs the dropless layer in its static form (a CUDA graph's)."""
        cfg = self.cfg
        h = rms_norm(x, p["ln2_scale"], cfg.norm_eps)
        with trace.span("model.moe", layer=layer,
                        tokens=h.shape[0] * h.shape[1]) as sp:
            if cfg.moe_routing == "dropless":
                out, rows = moe_dropless(
                    h, p["moe"], top_k=cfg.top_k, held=cfg.held,
                    static=decode, counts=self._routed_counter(x.device),
                    act=cfg.act, gated=cfg.gated_mlp)
                aux = None
                if sp is not None and rows is not None:
                    sp.attrs["rows"] = rows
            else:
                out, aux = moe_ffn(h, p["moe"], top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor,
                                   act=cfg.act, gated=cfg.gated_mlp,
                                   rules=rules)
        return x + constrain(out, rules, "btd"), aux

    def _routed_counter(self, device) -> torch.Tensor:
        """The (n_experts,) int64 count of routed choices on ``device``."""
        device = _device_key(device)
        if device not in self._routed:
            self._routed[device] = torch.zeros(self.cfg.n_experts,
                                               dtype=torch.int64, device=device)
        return self._routed[device]

    def routed_choices(self, device=None) -> Optional[torch.Tensor]:
        """Each expert's routed choices (top-k picks, held experts or not)
        that the dropless MoE layers made on ``device`` (the card unless
        ``"cpu"`` is asked for) since the model was built: the live (E,)
        int64 device tensor, or None where no such layer has run there."""
        return self._routed.get(_device_key(resolve_device(device)))

    # =========================================================================
    # superblock stack (Python loop over depth)
    # =========================================================================
    def _run_layers(self, stack_params, x, positions, *, names, n_layers,
                    cache=None, index=None, cross_stack=None, rules=None,
                    impl="auto", decode=False, remat=False, first_layer=0):
        """Returns ``(x, the MoE blocks' aux losses summed)``; the aux is None
        where no block made one, and with a cache (serving drops it).
        Superblock ``layer``'s cross block reads layer ``layer`` of
        ``cross_stack``.  The stack's first block is the model's layer
        ``first_layer``."""
        remat = remat and cache is None and torch.is_grad_enabled()
        aux = None
        layers = {name: _layers(stack_params[name], n_layers)
                  for name in names}
        cross = (None if cross_stack is None
                 else _layers(cross_stack, n_layers))
        for layer in range(n_layers):
            ckv = None if cross is None else cross[layer]
            for j, name in enumerate(names):
                kind = name.split("_", 1)[1]
                p = layers[name][layer]
                c_kv = ckv if kind == "cross" else None
                if remat:
                    x, aux_l = checkpoint(self._block_out, kind, p, x,
                                          positions, c_kv, rules, impl,
                                          use_reentrant=False)
                else:
                    c = (_index(cache[name], layer)
                         if cache is not None and name in cache else None)
                    x, state, aux_l = self._apply_block(
                        kind, p, x, positions, cache=c, index=index,
                        cross_kv=c_kv, rules=rules, impl=impl, decode=decode,
                        layer=first_layer + layer * len(names) + j)
                    if state is not None:
                        _write(c, state)
                if aux_l is not None and cache is None:
                    aux = aux_l if aux is None else aux + aux_l
            x = constrain(x, rules, "btd")
        return x, aux

    def _block_out(self, kind, p, x, positions, cross_kv, rules, impl):
        x, _, aux_l = self._apply_block(kind, p, x, positions,
                                        cross_kv=cross_kv, rules=rules,
                                        impl=impl)
        return x, aux_l

    def _run_all(self, params, x, positions, *, cross_stack=None, cache=None,
                 index=None, rules=None, impl="auto", decode=False,
                 remat=False):
        """Returns ``(final-normed x, aux loss summed over the layers or
        None)``."""
        cfg = self.cfg
        blocks = params["blocks"]
        if cfg.family == "encdec":
            x = self._run_encdec_decoder(
                params, x, positions, cross_stack,
                cache=None if cache is None else cache["blocks"]["b0_attn"],
                index=index, rules=rules, impl=impl, remat=remat)
            return self._final_norm(params, x), None
        x, aux = self._run_layers(
            blocks, x, positions, names=list(blocks), n_layers=cfg.n_super,
            cache=None if cache is None else cache["blocks"], index=index,
            cross_stack=cross_stack, rules=rules, impl=impl, decode=decode,
            remat=remat)
        if "tail" in params:
            x, _ = self._run_layers(
                params["tail"], x, positions, names=list(params["tail"]),
                n_layers=1, cache=None if cache is None else cache["tail"],
                index=index, rules=rules, impl=impl, decode=decode,
                first_layer=cfg.n_super * len(cfg.superblock))
        return self._final_norm(params, x), aux

    def _run_encdec_decoder(self, params, x, positions, cross_stack, *,
                            cache=None, index=None, rules=None, impl="auto",
                            remat=False):
        """The whisper decoder: per layer, causal self attention (writing
        ``cache`` in place), cross attention over layer l of
        ``cross_stack``, then the MLP."""
        remat = remat and cache is None and torch.is_grad_enabled()
        n = self.cfg.n_layers
        blocks = _layers(params["blocks"]["b0_attn"], n)
        cross = _layers(params["cross"], n)
        cross_kv = _layers(cross_stack, n)
        for layer in range(n):
            p_self, p_cross, ckv = blocks[layer], cross[layer], cross_kv[layer]
            if remat:
                x = checkpoint(self._decoder_layer, p_self, p_cross, ckv, x,
                               positions, None, None, rules, impl,
                               use_reentrant=False)
            else:
                c = None if cache is None else _index(cache, layer)
                x = self._decoder_layer(p_self, p_cross, ckv, x, positions,
                                        c, index, rules, impl)
        return x

    def _decoder_layer(self, p_self, p_cross, ckv, x, positions, cache, index,
                       rules, impl):
        cfg = self.cfg
        h = _norm(cfg, x, p_self, "ln1")
        x = x + self._self_attn(p_self["attn"], h, positions, cache=cache,
                                index=index, rules=rules, impl=impl)
        hx = _norm(cfg, x, p_cross, "lnx")
        x = x + self._cross_attn(p_cross["attn"], hx, ckv, rules=rules,
                                 impl=impl)
        return self._mlp_res(p_self, x, rules)

    # =========================================================================
    # embedding / head
    # =========================================================================
    def embed(self, params, tokens, positions=None):
        """Rows of the (Vp, D) table as ``jnp.take`` gives them: a negative
        id counts from the end, an id past either end reads NaN.  Where
        the params hold a position table (whisper's decoder), its rows at
        ``positions`` are added, read the same way."""
        dtype = self.cfg.dtype
        x = _take(params["embed"], tokens).to(dtype)
        if "pos_embed" in params:
            x = x + _take(params["pos_embed"], positions).to(dtype)
        return x

    def unembed(self, params, x, rules=None):
        if self.cfg.tie_embeddings:
            logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
        else:
            logits = torch.einsum("bsd,dv->bsv", x, params["unembed"])
        return constrain(logits, rules, "btv")

    def _final_norm(self, params, x):
        cfg = self.cfg
        if cfg.family == "encdec":
            return layer_norm(x, params["final_norm"], params["final_norm_bias"],
                              cfg.norm_eps)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    # =========================================================================
    # encoder / cross-attention memory
    # =========================================================================
    def encode(self, params, frames, rules=None, impl="auto", remat=True):
        """frames (B, T, D) → the whisper encoder's output (B, T, D):
        the position table added, bidirectional layers, LayerNorm."""
        cfg = self.cfg
        enc = params["encoder"]
        b, t = frames.shape[0], frames.shape[1]
        x = frames.to(cfg.dtype) + enc["pos_embed"][None, :t].to(cfg.dtype)
        pos = torch.arange(t, device=x.device).expand(b, t)
        remat = remat and torch.is_grad_enabled()
        for p in _layers(enc["blocks"], cfg.n_encoder_layers):
            if remat:
                x = checkpoint(self._encoder_layer, p, x, pos, rules, impl,
                               use_reentrant=False)
            else:
                x = self._encoder_layer(p, x, pos, rules, impl)
        return layer_norm(x, enc["final_norm"], enc["final_norm_bias"],
                          cfg.norm_eps)

    def _encoder_layer(self, p, x, pos, rules, impl):
        h = _norm(self.cfg, x, p, "ln1")
        x = x + self._self_attn(p["attn"], h, pos, causal=False, rules=rules,
                                impl=impl)
        return self._mlp_res(p, x, rules)

    def cross_kv(self, params, memory, rules=None):
        """The cross-attention K/V of every cross layer from ``memory``
        (B, T, D): {"k", "v"}, each (L_cross, B, T, Hkv, hd), one einsum
        over the stacked layer axis."""
        cfg = self.cfg
        if cfg.family == "encdec":
            stack = params["cross"]["attn"]
        else:  # vlm
            stack = params["blocks"][f"b{len(cfg.superblock) - 1}_cross"]["attn"]
        k = torch.einsum("btd,ldhk->lbthk", memory, stack["wk"])
        v = torch.einsum("btd,ldhk->lbthk", memory, stack["wv"])
        if cfg.qkv_bias:
            k = k + stack["bk"][:, None, None]
            v = v + stack["bv"][:, None, None]
        return {"k": constrain(k, rules, "xbtkk"),
                "v": constrain(v, rules, "xbtkk")}

    def _cross_stack(self, params, memory, rules, impl, remat):
        """The cross K/V the family's decoder reads, or None."""
        cfg = self.cfg
        if cfg.family == "encdec":
            enc_out = self.encode(params, memory, rules=rules, impl=impl,
                                  remat=remat)
            return self.cross_kv(params, enc_out, rules=rules)
        if cfg.family == "vlm":
            return self.cross_kv(params, memory.to(cfg.dtype), rules=rules)
        return None

    # =========================================================================
    # full forward (training / eval)
    # =========================================================================
    def forward(self, params, tokens, *, memory=None, rules=None, impl="auto",
                remat=True, positions=None):
        """tokens (B, S) → (logits (B, S, Vp), aux loss: the MoE blocks'
        sum, 0 in the other families).  ``memory`` is the ``vlm`` patch
        embeddings or the ``encdec`` frames, (B, T, D).

        ``remat`` checkpoints each block of the stack (not the tail, as the
        reference) and each encoder layer when autograd records; it
        changes no value."""
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = constrain(self.embed(params, tokens, positions), rules, "btd")
        cross_stack = self._cross_stack(params, memory, rules, impl, remat)
        x, aux = self._run_all(params, x, positions, cross_stack=cross_stack,
                               rules=rules, impl=impl, remat=remat)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return self.unembed(params, x, rules), aux

    # =========================================================================
    # loss
    # =========================================================================
    def loss_fn(self, params, batch, *, rules=None, impl="auto", remat=True):
        """Mean next-token cross entropy of ``batch`` ({"tokens", "labels"},
        (B, S) integer tensors on the params' device, and "memory" for the
        ``vlm`` and ``encdec`` families), plus ``router_aux_weight`` × the
        aux loss in the ``moe`` family; a float32 scalar."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch["tokens"],
                                   memory=batch.get("memory"), rules=rules,
                                   impl=impl, remat=remat)
        loss = softmax_cross_entropy(logits, batch["labels"],
                                     real_vocab=cfg.vocab_size, rules=rules)
        if cfg.family == "moe":
            loss = loss + cfg.router_aux_weight * aux
        return loss

    # =========================================================================
    # serving
    # =========================================================================
    def init_cache(self, batch: int, max_seq: int, dtype=None,
                   device=None) -> Dict[str, Any]:
        """Zeroed decode state on ``device`` (the card unless ``"cpu"``;
        ``"meta"`` gives shape-only leaves, never allocated)."""
        cfg = self.cfg
        dev = resolve_device(device)
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        dtype = dtype or cfg.dtype

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)

        ring = cfg.family == "hybrid" and cfg.window is not None

        def sub(kind, n):
            if kind in ("attn", "moe"):
                t = min(cfg.window, max_seq) if ring else max_seq
                c = {"k": zeros((n, batch, t, cfg.n_kv_heads, cfg.hd)),
                     "v": zeros((n, batch, t, cfg.n_kv_heads, cfg.hd))}
                if ring:
                    c["slot_pos"] = torch.full((n, batch, t), -(10**9),
                                               dtype=torch.int32, device=dev)
                return c
            if kind in ("mamba", "mamba_mlp", "mamba_moe"):
                return {"conv": zeros((n, batch, cfg.ssm_conv - 1, cfg.d_inner)),
                        "ssm": zeros((n, batch, cfg.d_inner, cfg.ssm_state),
                                     torch.float32)}
            if kind == "rglru":
                return {"conv": zeros((n, batch, cfg.ssm_conv - 1, cfg.lru_dim)),
                        "h": zeros((n, batch, cfg.lru_dim), torch.float32)}
            raise ValueError(kind)

        sb = cfg.superblock
        # cross blocks hold no cache: they read the prefill's cross_stack
        cache = {"blocks": {f"b{i}_{kind}": sub(kind, cfg.n_super)
                            for i, kind in enumerate(sb) if kind != "cross"}}
        if cfg.n_tail:
            cache["tail"] = {f"t{i}_{kind}": sub(kind, 1)
                             for i, kind in enumerate(sb[: cfg.n_tail])}
        return cache

    def decode_step(self, params, token, index, cache, *, cross_stack=None,
                    rules=None, impl="auto"):
        """token (B,), index scalar or (B,) → (logits (B, Vp), cache).

        The cache is updated in place and returned.  ``cross_stack`` is
        the one ``prefill`` returned (``vlm`` and ``encdec``).
        """
        b = token.shape[0]
        index = torch.as_tensor(index, device=token.device).long()
        if index.ndim == 0:
            positions = index.expand(b, 1)
        else:
            positions = index[:, None]
        x = constrain(self.embed(params, token[:, None], positions), rules,
                      "btd")
        x, _ = self._run_all(params, x, positions, cross_stack=cross_stack,
                             cache=cache, index=index, rules=rules, impl=impl,
                             decode=True)
        return self.unembed(params, x, rules)[:, 0], cache

    def prefill(self, params, tokens, *, memory=None, rules=None, impl="auto",
                max_seq=None):
        """Run the prompt; returns (last logits, cache, cross_stack).

        ``max_seq`` sizes the cache for subsequent decode steps (≥ prompt).
        ``memory`` (B, T, D) is the ``vlm`` patch embeddings or the
        ``encdec`` frames; ``impl`` is the attention of every layer of the
        prompt, the encoder's and the cross attention's included.  The
        cross-attention stack is computed once here, for the decode steps
        to reuse; None in the families without one.
        """
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = constrain(self.embed(params, tokens, positions), rules, "btd")
        cache = self.init_cache(b, max_seq or s, device=tokens.device)
        cross_stack = self._cross_stack(params, memory, rules, impl,
                                        remat=False)
        x, _ = self._run_all(params, x, positions, cross_stack=cross_stack,
                             cache=cache, index=0, rules=rules, impl=impl)
        return (self.unembed(params, x[:, -1:], rules)[:, 0], cache,
                cross_stack)

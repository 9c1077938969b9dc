"""Model assembly: one Model class for the families the port runs.

The port's counterpart of ``repro/models/model.py`` for ``dense``,
``moe``, ``ssm`` and ``hybrid``; ``vlm`` and ``encdec`` raise
``NotImplementedError`` (``ROADMAP.md`` §1).

Execution paths:
  * ``forward``      — full-sequence logits (training / eval) and the MoE
                       aux loss summed over the layers; ``loss_fn`` is the
                       mean cross entropy plus ``router_aux_weight`` × aux.
  * ``prefill``      — full sequence, returns last-position logits + cache.
  * ``decode_step``  — one token against a cache (serving inner loop).

Params keep the reference's stacked layout: each superblock leaf has a
leading layer axis, and depth is a Python loop over it (the reference's
``lax.scan``), so conversion stays one to one.  Caches are stacked the
same way.  With ``remat`` (the reference's ``jax.checkpoint`` with
``nothing_saveable`` around each superblock) each block of the stack runs
under ``torch.utils.checkpoint``: its activations are recomputed in the
backward and only its input is kept.  Where the reference returns a new
cache, the port writes the new state into the cache it was given, in
place, and returns it: a full width mamba state is 134 MB a step that
need not be copied.

Attention caches:
  * dense / moe self-attn — linear cache (B, Tmax, Hkv, hd), written at
    ``index``; the start is clamped as ``dynamic_update_slice`` clamps it.
  * hybrid local-attn — RING cache of size ``window`` with per-slot
    positions (stale slots overwritten; masking uses stored positions).
  * mamba / rglru — O(1) recurrent state (conv tail + ssm/lru state).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.common import resolve_device
from .config import ModelConfig
from .layers import attention, mlp, rms_norm, rope, softmax_cross_entropy
from .moe import moe_ffn
from .params import PORTED_FAMILIES, init_params
from .rglru import rglru_decode_step, rglru_seq
from .ssm import mamba_decode_step, mamba_seq

__all__ = ["Model"]


def _index(tree, i: int):
    """Layer ``i`` of a stacked param or cache tree (views, not copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _write(dst: Dict, src: Dict) -> None:
    """Copy a block's new state into its cache views (in place)."""
    for k, v in src.items():
        if v is not dst[k]:
            dst[k].copy_(v)


class Model:
    def __init__(self, cfg: ModelConfig, *, scan_impl: Optional[str] = None):
        """``scan_impl`` picks the linear scan of the recurrent blocks
        (``kernels/linear_scan/ops.py``): None runs K5 on the card."""
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"the {cfg.family!r} family is not ported yet; the port runs "
                f"{', '.join(PORTED_FAMILIES)} (see ROADMAP.md §1)")
        self.cfg = cfg
        self.scan_impl = scan_impl

    def init(self, generator=0, device=None):
        """Random params on ``device`` (the card unless ``"cpu"`` is asked)."""
        return init_params(self.cfg, generator, device)

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
                   window=None, impl="auto"):
        """Returns the attention output; writes ``cache`` in place."""
        cfg = self.cfg
        q, k, v = self._project_qkv(p, h)
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

        out = attention(q, k, v, q_positions=positions, k_positions=k_pos,
                        causal=True, window=window, impl=impl)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])

    def _mlp_res(self, p, x):
        cfg = self.cfg
        h = rms_norm(x, p["ln2_scale"], cfg.norm_eps)
        return x + mlp(h, p["mlp"], gated=cfg.gated_mlp, act=cfg.act)

    # =========================================================================
    # one block of a given kind
    # =========================================================================
    def _apply_block(self, kind, p, x, positions, *, cache=None, index=None,
                     impl="auto", decode=False):
        """Returns ``(x, new recurrent state or None, MoE aux loss or None)``."""
        cfg = self.cfg
        h = rms_norm(x, p["ln1_scale"], cfg.norm_eps)
        if kind in ("attn", "moe"):
            window = cfg.window if cfg.family == "hybrid" else None
            x = x + self._self_attn(p["attn"], h, positions, cache=cache,
                                    index=index, window=window, impl=impl)
            if kind == "attn":
                return self._mlp_res(p, x), None, None
            h2 = rms_norm(x, p["ln2_scale"], cfg.norm_eps)
            out, aux = moe_ffn(h2, p["moe"], top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               act=cfg.act, gated=cfg.gated_mlp)
            return x + out, None, aux
        if kind == "mamba":
            seq, step = mamba_seq, mamba_decode_step
        elif kind == "rglru":
            seq, step = rglru_seq, rglru_decode_step
        else:
            raise ValueError(kind)
        new_state = None
        if decode:
            out, new_state = step(h[:, 0], p[kind], cfg, cache)
            out = out[:, None]
        elif cache is not None:  # prefill: also emit the decode state
            out, new_state = seq(h, p[kind], cfg, scan_impl=self.scan_impl,
                                 return_cache=True)
        else:
            out = seq(h, p[kind], cfg, scan_impl=self.scan_impl)
        x = x + out
        if kind == "rglru":
            x = self._mlp_res(p, x)
        return x, new_state, None

    # =========================================================================
    # superblock stack (Python loop over depth)
    # =========================================================================
    def _run_layers(self, stack_params, x, positions, *, names, n_layers,
                    cache=None, index=None, impl="auto", decode=False,
                    remat=False):
        """Returns ``(x, the MoE blocks' aux losses summed)``; the aux is None
        where no block made one, and with a cache (serving drops it)."""
        remat = remat and cache is None and torch.is_grad_enabled()
        aux = None
        for layer in range(n_layers):
            for name in names:
                kind = name.split("_", 1)[1]
                p = _index(stack_params[name], layer)
                if remat:
                    x, aux_l = checkpoint(self._block_out, kind, p, x,
                                          positions, impl, use_reentrant=False)
                else:
                    c = _index(cache[name], layer) if cache is not None else None
                    x, state, aux_l = self._apply_block(
                        kind, p, x, positions, cache=c, index=index,
                        impl=impl, decode=decode)
                    if state is not None:
                        _write(c, state)
                if aux_l is not None and cache is None:
                    aux = aux_l if aux is None else aux + aux_l
        return x, aux

    def _block_out(self, kind, p, x, positions, impl):
        x, _, aux_l = self._apply_block(kind, p, x, positions, impl=impl)
        return x, aux_l

    def _run_all(self, params, x, positions, *, cache=None, index=None,
                 impl="auto", decode=False, remat=False):
        """Returns ``(final-normed x, aux loss summed over the layers or
        None)``."""
        cfg = self.cfg
        blocks = params["blocks"]
        x, aux = self._run_layers(
            blocks, x, positions, names=list(blocks), n_layers=cfg.n_super,
            cache=None if cache is None else cache["blocks"], index=index,
            impl=impl, decode=decode, remat=remat)
        if "tail" in params:
            x, _ = self._run_layers(
                params["tail"], x, positions, names=list(params["tail"]),
                n_layers=1, cache=None if cache is None else cache["tail"],
                index=index, impl=impl, decode=decode)
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux

    # =========================================================================
    # embedding / head
    # =========================================================================
    def embed(self, params, tokens):
        """Rows of the (Vp, D) table as ``jnp.take`` gives them: a negative
        id counts from the end, an id past either end reads NaN."""
        table = params["embed"]
        vp = table.shape[0]
        ids = tokens.long()
        ids = torch.where(ids < 0, ids + vp, ids)
        inside = (ids >= 0) & (ids < vp)
        x = table[ids.clamp(0, vp - 1)].to(self.cfg.dtype)
        return torch.where(inside[..., None], x, torch.nan)

    def unembed(self, params, x):
        if self.cfg.tie_embeddings:
            return torch.einsum("bsd,vd->bsv", x, params["embed"])
        return torch.einsum("bsd,dv->bsv", x, params["unembed"])

    # =========================================================================
    # full forward (training / eval)
    # =========================================================================
    def forward(self, params, tokens, *, impl="auto", remat=True,
                positions=None):
        """tokens (B, S) → (logits (B, S, Vp), aux loss: the MoE blocks'
        sum, 0 in the other families).

        ``remat`` checkpoints each block of the stack (not the tail, as the
        reference) when autograd records; it changes no value."""
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        x, aux = self._run_all(params, self.embed(params, tokens), positions,
                               impl=impl, remat=remat)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return self.unembed(params, x), aux

    # =========================================================================
    # loss
    # =========================================================================
    def loss_fn(self, params, batch, *, impl="auto", remat=True):
        """Mean next-token cross entropy of ``batch`` ({"tokens", "labels"},
        (B, S) integer tensors on the params' device), plus
        ``router_aux_weight`` × the aux loss in the ``moe`` family; a
        float32 scalar."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch["tokens"], impl=impl,
                                   remat=remat)
        loss = softmax_cross_entropy(logits, batch["labels"],
                                     real_vocab=cfg.vocab_size)
        if cfg.family == "moe":
            loss = loss + cfg.router_aux_weight * aux
        return loss

    # =========================================================================
    # serving
    # =========================================================================
    def init_cache(self, batch: int, max_seq: int, dtype=None,
                   device=None) -> Dict[str, Any]:
        """Zeroed decode state on ``device`` (the card unless ``"cpu"``)."""
        cfg = self.cfg
        dev = resolve_device(device)
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        dtype = dtype or cfg.dtype

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)

        def sub(kind, n):
            if kind in ("attn", "moe"):
                t = min(cfg.window, max_seq) if cfg.family == "hybrid" else max_seq
                c = {"k": zeros((n, batch, t, cfg.n_kv_heads, cfg.hd)),
                     "v": zeros((n, batch, t, cfg.n_kv_heads, cfg.hd))}
                if cfg.family == "hybrid":
                    c["slot_pos"] = torch.full((n, batch, t), -(10**9),
                                               dtype=torch.int32, device=dev)
                return c
            if kind == "mamba":
                return {"conv": zeros((n, batch, cfg.ssm_conv - 1, cfg.d_inner)),
                        "ssm": zeros((n, batch, cfg.d_inner, cfg.ssm_state),
                                     torch.float32)}
            if kind == "rglru":
                return {"conv": zeros((n, batch, cfg.ssm_conv - 1, cfg.lru_dim)),
                        "h": zeros((n, batch, cfg.lru_dim), torch.float32)}
            raise ValueError(kind)

        sb = cfg.superblock
        cache = {"blocks": {f"b{i}_{kind}": sub(kind, cfg.n_super)
                            for i, kind in enumerate(sb)}}
        if cfg.n_tail:
            cache["tail"] = {f"t{i}_{kind}": sub(kind, 1)
                             for i, kind in enumerate(sb[: cfg.n_tail])}
        return cache

    def decode_step(self, params, token, index, cache, *, impl="auto"):
        """token (B,), index scalar or (B,) → (logits (B, Vp), cache).

        The cache is updated in place and returned.
        """
        b = token.shape[0]
        index = torch.as_tensor(index, device=token.device).long()
        if index.ndim == 0:
            positions = index.expand(b, 1)
        else:
            positions = index[:, None]
        x = self.embed(params, token[:, None])
        x, _ = self._run_all(params, x, positions, cache=cache, index=index,
                             impl=impl, decode=True)
        return self.unembed(params, x)[:, 0], cache

    def prefill(self, params, tokens, *, impl="auto", max_seq=None):
        """Run the prompt; returns (last logits, cache, None).

        ``max_seq`` sizes the cache for subsequent decode steps (≥ prompt).
        The third value stands where the reference returns the cross-
        attention stack of the enc-dec and VLM families.
        """
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        cache = self.init_cache(b, max_seq or s, device=tokens.device)
        x, _ = self._run_all(params, self.embed(params, tokens), positions,
                             cache=cache, index=0, impl=impl)
        return self.unembed(params, x[:, -1:])[:, 0], cache, None

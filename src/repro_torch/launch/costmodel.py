"""Analytic FLOP/byte accounting per (arch × shape) cell.

The port's copy of ``repro/launch/costmodel.py``, the same code: it reads
only the config, its ``ArchInfo`` and the ``Shape``, and gives the
reference's numbers for the port's configs.

WHY THIS EXISTS: a compiler's per-program cost analysis counts each loop
body once, so a program that loops over its layers under-reports by
~L×micro.  The roofline therefore uses these implementation-accurate
analytic counts (every einsum in the model code is enumerated below).
The port's dry run records its own count beside them as a cross-check:
``torch.utils.flop_counter`` over the cell's function on meta tensors
(``launch/dryrun.py``), which sees matmuls only.

Conventions:
  * forward matmul FLOPs = 2·M·N·K; training = ×3 for fwd+bwd on
    embed/head (outside remat), ×4 for layer interiors (fwd + bwd(2) +
    remat recompute(1), since remat policy saves nothing).
  * attention scores/PV FLOPs follow the IMPLEMENTATION: the full/chunked
    paths compute all S×T logits (no causal skip); the 'triangle' path
    halves them.  This is exactly the kind of waste MODEL/HLO exposes.
  * HBM bytes are order-accurate estimates: parameter traffic (per pass,
    per microbatch), optimizer state traffic, activation stream traffic,
    KV-cache traffic.  Dominant-term identification is robust to the ~2×
    modelling error.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

__all__ = ["analytic_cost", "CellCost"]


@dataclass(frozen=True)
class CellCost:
    flops_global: float
    # parameter-side traffic (params/opt/grads): replicated under pure-DP,
    # else sharded /chips; stream traffic (activations/caches) always /chips
    param_traffic: float
    stream_traffic: float
    detail: dict

    def bytes_per_device(self, chips: int, *, params_replicated: bool) -> float:
        p = self.param_traffic if params_replicated else self.param_traffic / chips
        return p + self.stream_traffic / chips


def _attn_flops_per_tok(cfg, t_ctx: float, causal_save: bool = False) -> float:
    H, hd = cfg.n_heads, cfg.hd
    f = 4.0 * t_ctx * H * hd  # QK^T + PV
    return f * (0.5 if causal_save else 1.0)


def _proj_flops_per_tok(cfg) -> float:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return 2.0 * D * hd * (H + 2 * Hkv) + 2.0 * H * hd * D  # qkv + o


def _mlp_flops_per_tok(cfg) -> float:
    mats = 3 if cfg.gated_mlp else 2
    return 2.0 * mats * cfg.d_model * cfg.d_ff


def _moe_flops_per_tok(cfg, group_size: int = 512) -> float:
    D, E, Fe, k = cfg.d_model, cfg.n_experts, cfg.d_expert, cfg.top_k
    g = group_size
    cap = int(g * k / E * cfg.capacity_factor) + 1
    router = 2.0 * D * E
    dispatch = 2.0 * 2.0 * E * cap * D  # in + out one-hot einsums (per token)
    mats = 3 if cfg.gated_mlp else 2
    experts = 2.0 * mats * (E * cap / g) * D * Fe  # ≈ k·cf dense-expert cost
    return router + dispatch + experts


def _mamba_flops_per_tok(cfg) -> float:
    D, Dm, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    R, K = cfg.dt_rank_actual, cfg.ssm_conv
    return (2 * D * 2 * Dm + 2 * K * Dm + 2 * Dm * (R + 2 * N)
            + 2 * R * Dm + 12.0 * Dm * N + 2 * Dm * D)


def _rglru_flops_per_tok(cfg) -> float:
    D, Dr, K = cfg.d_model, cfg.lru_dim, cfg.ssm_conv
    bs = 256 if Dr >= 256 else Dr
    return (2 * D * 2 * Dr + 2 * K * Dr + 2 * 2 * Dr * bs + 10.0 * Dr
            + 2 * Dr * D)


def _layer_flops_per_tok(cfg, kind: str, t_ctx: float, *, causal_save=False,
                         t_mem: float = 0.0) -> float:
    if kind == "attn":
        return (_proj_flops_per_tok(cfg)
                + _attn_flops_per_tok(cfg, t_ctx, causal_save)
                + _mlp_flops_per_tok(cfg))
    if kind == "moe":
        return (_proj_flops_per_tok(cfg)
                + _attn_flops_per_tok(cfg, t_ctx, causal_save)
                + _moe_flops_per_tok(cfg))
    if kind == "mamba":
        return _mamba_flops_per_tok(cfg)
    if kind == "rglru":
        return _rglru_flops_per_tok(cfg) + _mlp_flops_per_tok(cfg)
    if kind == "cross":
        D, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
        q_and_o = 2.0 * D * H * hd + 2.0 * H * hd * D
        return (q_and_o + _attn_flops_per_tok(cfg, t_mem)
                + _mlp_flops_per_tok(cfg))
    raise ValueError(kind)


def _layer_kinds(cfg):
    """(kind, count) across the full depth, incl. tail layers."""
    sb = cfg.superblock
    counts = {}
    for k in sb:
        counts[k] = counts.get(k, 0) + cfg.n_super
    for k in sb[: cfg.n_tail]:
        counts[k] = counts.get(k, 0) + 1
    return counts


def _fwd_flops_per_tok(cfg, t_ctx: float, *, causal_save=False) -> float:
    total = 0.0
    t_mem = cfg.encoder_seq if cfg.family == "encdec" else cfg.vision_seq
    for kind, n in _layer_kinds(cfg).items():
        # hybrid local attention: context bounded by the window
        t_eff = min(t_ctx, cfg.window) if (cfg.family == "hybrid" and kind == "attn") else t_ctx
        total += n * _layer_flops_per_tok(cfg, kind, t_eff,
                                          causal_save=causal_save, t_mem=t_mem)
    if cfg.family == "encdec":
        # decoder cross-attn stack (one per decoder layer)
        D, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
        total += cfg.n_layers * (2.0 * D * H * hd + 2.0 * H * hd * D
                                 + _attn_flops_per_tok(cfg, t_mem))
    total += 2.0 * cfg.d_model * cfg.padded_vocab  # unembed
    return total


def _encoder_flops(cfg, batch: int) -> float:
    if cfg.family != "encdec":
        return 0.0
    per_tok = (_proj_flops_per_tok(cfg)
               + _attn_flops_per_tok(cfg, cfg.encoder_seq)
               + _mlp_flops_per_tok(cfg))
    return batch * cfg.encoder_seq * cfg.n_encoder_layers * per_tok


def _cross_kv_flops(cfg, batch: int) -> float:
    D, Hkv, hd = cfg.d_model, cfg.n_kv_heads, cfg.hd
    if cfg.family == "encdec":
        return batch * cfg.encoder_seq * cfg.n_layers * 2 * D * 2 * Hkv * hd
    if cfg.family == "vlm":
        return batch * cfg.vision_seq * cfg.n_super * 2 * D * 2 * Hkv * hd
    return 0.0


def analytic_cost(cfg, info, shape, *, attn_impl: str = "chunked") -> CellCost:
    """Global FLOPs + HBM bytes for one cell (both meshes are identical
    globally; per-device = global / chips)."""
    causal_save = attn_impl == "triangle"
    P = cfg.param_count()
    P_b = 2.0 * P  # bf16 residency
    tokens = shape.batch * shape.seq

    if shape.kind == "train":
        M = info.microbatches.get(shape.name, 1)
        fwd = tokens * _fwd_flops_per_tok(cfg, shape.seq, causal_save=causal_save)
        fwd += _encoder_flops(cfg, shape.batch) + _cross_kv_flops(cfg, shape.batch)
        flops = 4.0 * fwd  # fwd + remat-recompute + bwd(2×)
        # opt update flops negligible (O(P))
        act_stream = 6.0 * tokens * cfg.d_model * 2.0 * (
            cfg.n_layers + cfg.n_encoder_layers)
        opt_traffic = {"adamw": 4 * 4.0 * P,  # m,v read+write f32
                       "adafactor": 0.1 * P}[info.optimizer]
        grads = 2 * 4.0 * P  # f32 accumulate read+write (amortized)
        param_traffic = 3.0 * M * P_b + opt_traffic + grads
        detail = {"microbatches": M, "fwd_flops": fwd}
        return CellCost(flops_global=flops, param_traffic=param_traffic,
                        stream_traffic=act_stream, detail=detail)
    elif shape.kind == "prefill":
        fwd = tokens * _fwd_flops_per_tok(cfg, shape.seq, causal_save=causal_save)
        fwd += _encoder_flops(cfg, shape.batch) + _cross_kv_flops(cfg, shape.batch)
        flops = fwd
        kv_write = _cache_bytes(cfg, shape)
        act_stream = 4.0 * tokens * cfg.d_model * 2.0 * cfg.n_layers
        detail = {"kv_cache_bytes": kv_write}
        return CellCost(flops_global=flops, param_traffic=P_b,
                        stream_traffic=act_stream + kv_write, detail=detail)
    else:  # decode: one token per sequence
        tokens = shape.batch
        fwd = tokens * _fwd_flops_per_tok(cfg, shape.seq)
        fwd += _cross_kv_flops(cfg, 0)  # cross kv precomputed, an input
        flops = fwd
        cache = _cache_bytes(cfg, shape)
        detail = {"kv_cache_bytes": cache}
        # every decode step streams all (active) params + the whole cache
        return CellCost(flops_global=flops, param_traffic=P_b,
                        stream_traffic=cache, detail=detail)


def _cache_bytes(cfg, shape) -> float:
    """Bytes of the decode cache this cell reads/writes."""
    b = shape.batch
    t = shape.seq
    kinds = _layer_kinds(cfg)
    total = 0.0
    for kind, n in kinds.items():
        if kind in ("attn", "moe"):
            t_eff = min(t, cfg.window) if cfg.family == "hybrid" else t
            total += n * b * t_eff * cfg.n_kv_heads * cfg.hd * 2 * 2.0
        elif kind == "mamba":
            total += n * b * (cfg.d_inner * cfg.ssm_state * 4.0
                              + (cfg.ssm_conv - 1) * cfg.d_inner * 2.0)
        elif kind == "rglru":
            total += n * b * (cfg.lru_dim * 4.0
                              + (cfg.ssm_conv - 1) * cfg.lru_dim * 2.0)
        elif kind == "cross":
            t_mem = cfg.vision_seq or cfg.encoder_seq
            total += n * b * t_mem * cfg.n_kv_heads * cfg.hd * 2 * 2.0
    if cfg.family == "encdec":
        total += cfg.n_layers * b * cfg.encoder_seq * cfg.n_kv_heads * cfg.hd * 2 * 2.0
    return total

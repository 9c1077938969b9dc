"""Parameter templates: one source of truth for shapes, shardings, inits.

The port's counterpart of ``repro/models/params.py`` for every family of
the reference (``dense``, ``moe``, ``ssm``, ``hybrid``, ``vlm``,
``encdec``).  A template is a nested dict of ``P`` leaves with the
reference's shapes -- stacked superblocks carry a leading layer axis --,
its init recipes (fan-in normal, ``alog``, ``dtbias``, ``lam``, ``pos``)
and its logical specs (``param_specs``: "fsdp", "model" or None per dim,
resolved to mesh axes by ``distributed.sharding``).

Sharding conventions (model axis = 16 on the production mesh):
  * attention: heads on "model" when divisible (attn_shard="heads"), else
    head_dim on "model" (attn_shard="headdim"); kv heads shard only when
    divisible, else replicated (GQA kv ≤ model-axis).
  * MLP: d_ff on "model"; MoE: experts on "model" (moe_shard="expert") or
    expert-FFN dim on "model" (moe_shard="ffn", for E % 16 ≠ 0).
  * FSDP: the d_model dim of every big matrix on "fsdp".
  * embeddings: vocab on "model", d_model on "fsdp".

``init_params`` builds every leaf on the device from one seeded
``torch.Generator``: the full width is never built on the host.  Its
numbers differ from ``jax.random``'s for the same seed; the tests carry
the reference's params over with ``repro_torch.convert.model_params``.
The sinusoid tables (``pos``) are computed in float64 numpy as the
reference computes them, so both packages' tables are bit-equal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.common import resolve_device
from .config import ModelConfig

__all__ = ["P", "build_template", "init_params", "param_specs",
           "PORTED_FAMILIES"]

#: families whose blocks the port builds and runs
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")


@dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    spec: Tuple = ()  # logical names per dim: "fsdp" | "model" | None;
    #                   () replicates every dim
    init: str = "normal"  # normal | zeros | ones | alog | dtbias | lam | pos
    fan_in: Optional[int] = None  # stddev = 1/sqrt(fan_in); default shape[-2]
    dtype: Any = None  # None → cfg.dtype; norms/scalars force f32


# ---------------------------------------------------------------------------
# Template builders
# ---------------------------------------------------------------------------


def _attn_tpl(cfg: ModelConfig, L: int, *, cross: bool = False) -> Dict[str, P]:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ax = cfg.model_axis_size
    if cfg.attn_shard == "heads":
        q_spec = (None, "fsdp", "model", None)
        kv_spec = (None, "fsdp", "model" if Hkv % ax == 0 else None, None)
        o_spec = (None, "model", None, "fsdp")
        bq_spec = (None, "model", None)
        bkv_spec = (None, "model" if Hkv % ax == 0 else None, None)
    else:  # headdim
        q_spec = (None, "fsdp", None, "model")
        kv_spec = (None, "fsdp", None, "model")
        o_spec = (None, None, "model", "fsdp")
        bq_spec = (None, None, "model")
        bkv_spec = (None, None, "model")
    t = {
        "wq": P((L, D, H, hd), q_spec, fan_in=D),
        "wk": P((L, D, Hkv, hd), kv_spec, fan_in=D),
        "wv": P((L, D, Hkv, hd), kv_spec, fan_in=D),
        "wo": P((L, H, hd, D), o_spec, fan_in=H * hd),
    }
    if cfg.qkv_bias:
        t["bq"] = P((L, H, hd), bq_spec, init="zeros")
        t["bk"] = P((L, Hkv, hd), bkv_spec, init="zeros")
        t["bv"] = P((L, Hkv, hd), bkv_spec, init="zeros")
    if cfg.qk_norm:
        t["q_norm"] = P((L, hd), (None, None), init="zeros", dtype=torch.float32)
        t["k_norm"] = P((L, hd), (None, None), init="zeros", dtype=torch.float32)
    if cross:
        t["gate_attn"] = P((L,), (None,), init="zeros", dtype=torch.float32)
    return t


def _mlp_tpl(cfg: ModelConfig, L: int) -> Dict[str, P]:
    D, F = cfg.d_model, cfg.d_ff
    t = {
        "w_up": P((L, D, F), (None, "fsdp", "model"), fan_in=D),
        "w_down": P((L, F, D), (None, "model", "fsdp"), fan_in=F),
    }
    if cfg.gated_mlp:
        t["w_gate"] = P((L, D, F), (None, "fsdp", "model"), fan_in=D)
    if cfg.family == "encdec":  # whisper carries biases
        t["b_up"] = P((L, F), (None, "model"), init="zeros")
        t["b_down"] = P((L, D), (None, None), init="zeros")
    return t


def _norm_tpl(cfg: ModelConfig, L: int, name: str) -> Dict[str, P]:
    D = cfg.d_model
    t = {f"{name}_scale": P((L, D), (None, None), init="zeros",
                            dtype=torch.float32)}
    if cfg.family == "encdec":  # LayerNorm (scale+bias); others are RMSNorm
        t[f"{name}_bias"] = P((L, D), (None, None), init="zeros",
                              dtype=torch.float32)
    return t


def _moe_tpl(cfg: ModelConfig, L: int) -> Dict[str, P]:
    """The router over all ``n_experts``; the weights of the held experts."""
    D, E, Fe = cfg.d_model, cfg.held[1], cfg.d_expert
    if cfg.moe_shard == "expert":
        up_spec = (None, "model", "fsdp", None)
        down_spec = (None, "model", None, "fsdp")
    else:  # ffn: shard the expert-FFN dim (E not divisible by mesh axis)
        up_spec = (None, None, "fsdp", "model")
        down_spec = (None, None, "model", "fsdp")
    return {
        "router": P((L, D, cfg.n_experts), (None, "fsdp", None), fan_in=D,
                    dtype=torch.float32),
        "w_gate": P((L, E, D, Fe), up_spec, fan_in=D),
        "w_up": P((L, E, D, Fe), up_spec, fan_in=D),
        "w_down": P((L, E, Fe, D), down_spec, fan_in=Fe),
    }


def _mamba_tpl(cfg: ModelConfig, L: int) -> Dict[str, P]:
    D, Dm, N, K, R = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv,
                      cfg.dt_rank_actual)
    t = {
        "in_proj": P((L, D, 2, Dm), (None, "fsdp", None, "model"), fan_in=D),
        "conv_w": P((L, K, Dm), (None, None, "model"), fan_in=K),
        "conv_b": P((L, Dm), (None, "model"), init="zeros"),
        "x_proj": P((L, Dm, R + 2 * N), (None, "model", None), fan_in=Dm),
        "dt_proj": P((L, R, Dm), (None, None, "model"), fan_in=R),
        "dt_bias": P((L, Dm), (None, "model"), init="dtbias",
                     dtype=torch.float32),
        "a_log": P((L, Dm, N), (None, "model", None), init="alog",
                   dtype=torch.float32),
        "d_skip": P((L, Dm), (None, "model"), init="ones", dtype=torch.float32),
        "out_proj": P((L, Dm, D), (None, "model", "fsdp"), fan_in=Dm),
    }
    if cfg.mamba_norms:  # RMSNorm scales of dt, B and C (``1 + scale``)
        for name, n in (("dt_norm", R), ("b_norm", N), ("c_norm", N)):
            t[name] = P((L, n), (None, None), init="zeros", dtype=torch.float32)
    return t


def _rglru_tpl(cfg: ModelConfig, L: int) -> Dict[str, P]:
    D, Dr, K = cfg.d_model, cfg.lru_dim, cfg.ssm_conv
    nb = max(1, Dr // 256)  # block-diagonal gate projections (Griffin)
    bs = Dr // nb
    return {
        "in_x": P((L, D, Dr), (None, "fsdp", "model"), fan_in=D),
        "in_gate": P((L, D, Dr), (None, "fsdp", "model"), fan_in=D),
        "conv_w": P((L, K, Dr), (None, None, "model"), fan_in=K),
        "conv_b": P((L, Dr), (None, "model"), init="zeros"),
        "gate_r": P((L, nb, bs, bs), (None, "model", None, None), fan_in=bs),
        "gate_i": P((L, nb, bs, bs), (None, "model", None, None), fan_in=bs),
        "gate_r_b": P((L, Dr), (None, "model"), init="zeros"),
        "gate_i_b": P((L, Dr), (None, "model"), init="zeros"),
        "lam": P((L, Dr), (None, "model"), init="lam", dtype=torch.float32),
        "out_proj": P((L, Dr, D), (None, "model", "fsdp"), fan_in=Dr),
    }


def _block_tpl(cfg: ModelConfig, kind: str, L: int) -> Dict[str, Any]:
    if kind == "attn":
        return {
            **_norm_tpl(cfg, L, "ln1"), "attn": _attn_tpl(cfg, L),
            **_norm_tpl(cfg, L, "ln2"), "mlp": _mlp_tpl(cfg, L),
        }
    if kind == "moe":
        return {
            **_norm_tpl(cfg, L, "ln1"), "attn": _attn_tpl(cfg, L),
            **_norm_tpl(cfg, L, "ln2"), "moe": _moe_tpl(cfg, L),
        }
    if kind == "mamba":
        return {**_norm_tpl(cfg, L, "ln1"), "mamba": _mamba_tpl(cfg, L)}
    if kind == "mamba_mlp":
        return {
            **_norm_tpl(cfg, L, "ln1"), "mamba": _mamba_tpl(cfg, L),
            **_norm_tpl(cfg, L, "ln2"), "mlp": _mlp_tpl(cfg, L),
        }
    if kind == "mamba_moe":
        return {
            **_norm_tpl(cfg, L, "ln1"), "mamba": _mamba_tpl(cfg, L),
            **_norm_tpl(cfg, L, "ln2"), "moe": _moe_tpl(cfg, L),
        }
    if kind == "rglru":
        return {
            **_norm_tpl(cfg, L, "ln1"), "rglru": _rglru_tpl(cfg, L),
            **_norm_tpl(cfg, L, "ln2"), "mlp": _mlp_tpl(cfg, L),
        }
    if kind == "cross":
        return {
            **_norm_tpl(cfg, L, "ln1"), "attn": _attn_tpl(cfg, L, cross=True),
            **_norm_tpl(cfg, L, "ln2"), "mlp": _mlp_tpl(cfg, L),
            "gate_mlp": P((L,), (None,), init="zeros", dtype=torch.float32),
        }
    raise ValueError(kind)


def build_template(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    D, Vp = cfg.d_model, cfg.padded_vocab
    f32 = torch.float32
    tpl: Dict[str, Any] = {
        "embed": P((Vp, D), ("model", "fsdp"), fan_in=1),
        "final_norm": P((D,), (None,), init="zeros", dtype=f32),
    }
    if cfg.family == "encdec":
        tpl["final_norm_bias"] = P((D,), (None,), init="zeros", dtype=f32)
    if not cfg.tie_embeddings:
        tpl["unembed"] = P((D, Vp), ("fsdp", "model"), fan_in=D)
    if cfg.max_pos_embed:
        tpl["pos_embed"] = P((cfg.max_pos_embed, D), (None, "fsdp"), init="pos")
    sb = cfg.superblock
    tpl["blocks"] = {f"b{i}_{kind}": _block_tpl(cfg, kind, cfg.n_super)
                     for i, kind in enumerate(sb)}
    if cfg.n_tail:
        tpl["tail"] = {f"t{i}_{kind}": _block_tpl(cfg, kind, 1)
                       for i, kind in enumerate(sb[: cfg.n_tail])}
    if cfg.family == "encdec":
        tpl["encoder"] = {
            "pos_embed": P((cfg.encoder_seq, D), (None, "fsdp"), init="pos"),
            "blocks": _block_tpl(cfg, "attn", cfg.n_encoder_layers),
            "final_norm": P((D,), (None,), init="zeros", dtype=f32),
            "final_norm_bias": P((D,), (None,), init="zeros", dtype=f32),
        }
        # decoder cross-attention stack (parallel to self-attn stack)
        tpl["cross"] = {**_norm_tpl(cfg, cfg.n_layers, "lnx"),
                        "attn": _attn_tpl(cfg, cfg.n_layers)}
    return tpl


# ---------------------------------------------------------------------------
# Materialization
# ---------------------------------------------------------------------------


def _normal(shape, std, dtype, gen, device) -> torch.Tensor:
    """N(0, std²) in ``dtype``; a stacked leaf is drawn one layer at a time
    so that its float32 draw never takes the whole stack's memory."""
    if len(shape) < 3:
        return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = torch.randn(shape[1:], generator=gen, device=device) * std
    return out


def _init_leaf(p: P, cfg: ModelConfig, gen: Optional[torch.Generator],
               device: torch.device) -> torch.Tensor:
    dtype = p.dtype or cfg.dtype
    if device.type == "meta":  # shape and dtype only, never allocated
        return torch.empty(p.shape, dtype=dtype, device=device)
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "normal":
        fan = p.fan_in if p.fan_in else (p.shape[-2] if len(p.shape) >= 2 else p.shape[-1])
        return _normal(p.shape, 1.0 / math.sqrt(max(fan, 1)), dtype, gen, device)
    if p.init == "alog":  # mamba: A = -exp(a_log), a_log = log(1..N)
        n = p.shape[-1]
        base = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
        return base.expand(p.shape).to(dtype).contiguous()
    if p.init == "dtbias":  # softplus^-1 of dt ~ LogUniform[1e-3, 1e-1]
        u = torch.rand(p.shape, generator=gen, device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        return torch.log(torch.expm1(dt)).to(dtype)
    if p.init == "lam":  # RG-LRU Λ: a^c ∈ [0.9, 0.999], a = sigmoid(Λ), c=8
        u = torch.rand(p.shape, generator=gen, device=device) * (0.999 - 0.9) + 0.9
        a = u ** (1.0 / 8.0)
        return torch.log(a / (1 - a)).to(dtype)
    if p.init == "pos":  # sinusoidal table, in float64 as the reference
        s, d = p.shape
        pos = np.arange(s)[:, None]
        i = np.arange(d)[None, :]
        angle = pos / np.power(10000.0, (2 * (i // 2)) / d)
        tab = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
        return torch.from_numpy(tab).to(device=device, dtype=dtype)
    raise ValueError(p.init)


def _materialize(tpl, cfg, gen, device):
    if isinstance(tpl, P):
        return _init_leaf(tpl, cfg, gen, device)
    return {k: _materialize(v, cfg, gen, device) for k, v in tpl.items()}


def init_params(cfg: ModelConfig, generator: Union[torch.Generator, int] = 0,
                device=None) -> Dict[str, Any]:
    """Every leaf of ``cfg``'s template, drawn on ``device`` (the card unless
    ``"cpu"`` is asked for).  ``generator`` is a ``torch.Generator`` on that
    device, or an int seed for one.  On ``"meta"`` the leaves carry shape
    and dtype only (the dry run's params): nothing is drawn or allocated."""
    dev = resolve_device(device)
    if dev.type == "meta":
        generator = None
    elif isinstance(generator, int):
        seed, generator = generator, torch.Generator(device=dev)
        generator.manual_seed(seed)
    return _materialize(build_template(cfg), cfg, generator, dev)


def _specs(tpl):
    if isinstance(tpl, P):
        return tpl.spec
    return {k: _specs(v) for k, v in tpl.items()}


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The template's logical specs: a tree of tuples shaped like the
    params, one entry per dim ("fsdp", "model" or None), resolved to mesh
    axes by ``distributed.sharding.resolve_param_specs``."""
    return _specs(build_template(cfg))

"""Roofline analysis of a dry-run cell at H100 constants.

The port's counterpart of ``repro/launch/roofline.py``.  Three terms per
(arch × shape × mesh), in seconds:

    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

The constants are NVIDIA's H100 SXM data sheet (dense, no sparsity, at
the 700 W power limit): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s
of HBM3, and NVLink 4 at 450 GB/s a direction (900 GB/s counts both).
The ring accounting below counts the bytes each device SENDS, so the link
rate is one direction's.

Per-device link traffic per op, ring-algorithm accounting:

    all-gather        out_bytes · (g−1)/g
    reduce-scatter    in_bytes  · (g−1)/g      (= out·(g−1))
    all-reduce        2 · bytes · (g−1)/g
    all-to-all        bytes · (g−1)/g
    collective-permute  bytes

The reference parses these ops out of XLA's optimized HLO.  torch has no
such program, so :func:`collective_bytes_from_rules` counts the
collectives that a cell's ``ShardingRules`` imply, kind by kind (its
docstring lists them).

MODEL_FLOPS (global): 6·N·tokens for training (2 fwd + 4 bwd), 2·N_active·tokens
for inference — attention FLOPs excluded by convention, so the reported
MODEL/HLO ratio also exposes attention + dispatch overheads.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..distributed.sharding import guard_spec, resolve_param_specs
from ..models.params import P, build_template, param_specs

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "CollectiveStats", "Roofline",
           "collective_bytes_from_rules", "model_flops"]

PEAK_FLOPS = 989e12  # bf16 dense / card (H100 SXM)
HBM_BW = 3.35e12  # bytes/s / card (HBM3)
LINK_BW = 450e9  # bytes/s / card, one direction (NVLink 4)


@dataclass
class CollectiveStats:
    bytes_on_link: float = 0.0
    by_kind: Dict[str, float] = field(default_factory=dict)
    count: int = 0

    def add(self, kind: str, b: float) -> None:
        self.bytes_on_link += b
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + b
        self.count += 1


def _op_link_bytes(kind: str, out_b: float, g: int) -> float:
    frac = (g - 1) / g
    if kind == "all-gather":
        return out_b * frac
    if kind == "all-reduce":
        return 2.0 * out_b * frac
    if kind == "reduce-scatter":
        return out_b * (g - 1)  # in = out·g ; moved = in·(g−1)/g
    if kind == "all-to-all":
        return out_b * frac
    if kind == "collective-permute":
        return out_b
    return 0.0


# ---------------------------------------------------------------------------
# Collectives implied by the sharding rules
# ---------------------------------------------------------------------------


def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _extent(axes, mesh_shape) -> int:
    return math.prod(mesh_shape[a] for a in axes)


def _param_leaves(tpl, specs):
    """(template leaf, resolved spec) pairs of a param tree."""
    if isinstance(tpl, P):
        yield tpl, specs
        return
    for k in tpl:
        yield from _param_leaves(tpl[k], specs[k])


def _sites(cfg, kind: str):
    """Each block of the model that ends in a collective under tensor
    parallelism, as (site, count, on the encoder?): self "attn" (Ulysses
    applies), "xattn" (cross attention), "mlp", "mixer" (mamba/RG-LRU),
    "moe"."""
    per_kind = {"attn": ("attn", "mlp"), "moe": ("attn", "moe"),
                "mamba": ("mixer",), "rglru": ("mixer", "mlp"),
                "cross": ("xattn", "mlp")}
    counts: Dict[str, int] = {}
    for k in cfg.superblock:
        counts[k] = counts.get(k, 0) + cfg.n_super
    for k in cfg.superblock[: cfg.n_tail]:
        counts[k] = counts.get(k, 0) + 1
    out = [(site, n, False) for k, n in counts.items() for site in per_kind[k]]
    if cfg.family == "encdec":
        out.append(("xattn", cfg.n_layers, False))
        if kind != "decode":  # decode reads the precomputed cross stack
            out += [("attn", cfg.n_encoder_layers, True),
                    ("mlp", cfg.n_encoder_layers, True)]
    return out


def collective_bytes_from_rules(cfg, info, shape, rules) -> CollectiveStats:
    """Per-device link bytes of the collectives ``rules`` imply for one
    step of the cell (``shape``: train step, prefill or decode step).

    Counted, each op with the ring accounting above:

    * **FSDP all-gather** of each parameter leaf with an ``fsdp`` entry in
      its guarded spec, over the fsdp axes, of the leaf's bytes on its
      model shard: once a pass, and a train step makes three passes
      (forward, remat recompute, backward) per microbatch;
    * **its gradient's reduce-scatter** (train), once per microbatch;
    * **the gradient all-reduce of replicated leaves** (train): a leaf the
      fsdp axes do not shard (every leaf under pure DP) all-reduces its
      gradient over the batch axes it is not split on, once per
      microbatch;
    * **the tensor-parallel all-reduce of the ``btd`` output** of each
      attention block, MLP, recurrent mixer (mamba / RG-LRU: their output
      projection contracts the model-sharded inner dim) and ``ffn``-sharded
      MoE FFN, over the model axes, on the local (B, S, D) activation, once
      a pass (sequence parallelism splits it into a reduce-scatter and an
      all-gather of the same total);
    * **the Ulysses all-to-alls** of ``headdim`` archs with S > 1: the
      queries in and the attention output back (all-to-all), and the
      keys and values gathered whole over the model axes (all-gather),
      per self-attention layer and pass;
    * **the MoE dispatch all-to-alls** of expert-sharded MoE: the
      (G, E, C, D) dispatch tensor to the experts and their outputs back,
      per MoE layer and pass.

    Not counted: the decode-time combine of a sequence-sharded KV cache,
    the logits and embedding gathers, and the optimizer (local).
    """
    mesh = rules.mesh.shape
    stats = CollectiveStats()
    train = shape.kind == "train"
    fsdp = set(rules.fsdp_axes)
    n_model = _extent(rules.model_axes, mesh)
    n_batch = _extent(rules.batch_axes, mesh)
    micro = info.microbatches.get(shape.name, 1) if train else 1
    micro = max(1, min(micro, shape.batch // max(n_batch, 1)))
    passes = 3 if train else 1  # fwd, remat recompute, bwd

    def add(kind, out_b, g, times):
        if g > 1 and out_b > 0:
            b = _op_link_bytes(kind, out_b, g)
            for _ in range(times):
                stats.add(kind, b)

    # parameters: FSDP gathers, gradient reduce-scatters and all-reduces
    tpl = build_template(cfg)
    specs = resolve_param_specs(param_specs(cfg), rules)
    for leaf, spec in _param_leaves(tpl, specs):
        spec = guard_spec(spec, leaf.shape, mesh)
        dt = leaf.dtype or cfg.dtype
        nbytes = math.prod(leaf.shape) * dt.itemsize
        used = [a for e in spec for a in _axes(e)]
        g_f = _extent([a for a in used if a in fsdp], mesh)
        shard = nbytes / _extent([a for a in used if a not in fsdp], mesh)
        if g_f > 1:
            add("all-gather", shard, g_f, passes * micro)
            if train:
                add("reduce-scatter", shard / g_f, g_f, micro)
        elif train:
            g_b = _extent([a for a in rules.batch_axes if a not in used], mesh)
            add("all-reduce", shard, g_b, micro)

    if n_model <= 1:
        return stats
    # activations, per pass over the step's tokens (all microbatches)
    ab = cfg.dtype.itemsize
    rows = shape.batch / max(n_batch, 1)
    s = shape.seq if shape.kind in ("train", "prefill") else 1
    H, Hkv, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    rows /= micro  # one op per microbatch, on its rows
    for site, n, encoder in _sites(cfg, shape.kind):
        t = cfg.encoder_seq if encoder else s
        times = n * passes * micro
        if site == "moe" and rules.shard_moe_expert:
            g = min(512, t)
            cap = int(g * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
            gecd = rows * t / g * cfg.n_experts * cap * D * ab / n_model
            add("all-to-all", gecd, n_model, 2 * times)
            continue
        add("all-reduce", rows * t * D * ab, n_model, times)
        if site == "attn" and rules.attn_shard == "headdim" and t > 1:
            q = rows * t * H * hd * ab / n_model
            add("all-to-all", q, n_model, 2 * times)
            add("all-gather", rows * t * Hkv * hd * ab, n_model, 2 * times)
    return stats


# ---------------------------------------------------------------------------
# The roofline row
# ---------------------------------------------------------------------------


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective: CollectiveStats
    model_flops_global: float
    memory_stats: Optional[dict] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective.bytes_on_link / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def model_vs_hlo(self) -> float:
        """MODEL_FLOPS / (counted FLOPs × chips): useful-compute fraction."""
        total = self.flops_per_device * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful model FLOP/s at the bound implied by the dominant term,
        as a fraction of the cluster's peak FLOP/s."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        achieved = self.model_flops_global / t  # FLOP/s if bound-limited
        return achieved / (self.chips * PEAK_FLOPS)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective.bytes_on_link,
            "collective_by_kind": self.collective.by_kind,
            "n_collectives": self.collective.count,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_global": self.model_flops_global,
            "model_vs_hlo": self.model_vs_hlo,
            "roofline_fraction": self.roofline_fraction,
            "memory": self.memory_stats,
        }


def model_flops(cfg, shape) -> float:
    """6·N_active·tokens (train) / 2·N_active·tokens (inference)."""
    n = cfg.active_param_count()
    tokens = shape.batch * (shape.seq if shape.kind in ("train", "prefill") else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens

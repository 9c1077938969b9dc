"""Sharding rules: logical axis names → mesh specs, and the auction's rows.

The port's counterpart of ``repro/distributed/sharding.py``.  A spec is a
plain tuple with one entry per dim: ``None`` (replicated) or a tuple of
mesh axis names the dim is split over, as the entries of a
``jax.sharding.PartitionSpec`` are.  ``guard_spec`` drops entries whose
mesh extent does not divide the dim.

Model half.  Parameters carry LOGICAL spec tuples ("fsdp" | "model" | None
per dim, ``models/params.py``); activations are constrained by KIND
strings inside the model code.  ``ShardingRules`` resolves both against a
mesh (``launch/mesh.py::Mesh``):

  fsdp  → ``fsdp_axes``  (single-pod: ("data",); multi-pod: ("pod","data"))
  model → ("model",)

Activation kinds:
  btd   (B, S, D)        residual stream
  btf   (B, S, F)        mlp hidden          — F on model
  btm   (B, S, Dm)       ssm/rglru inner     — Dm on model
  bshk  (B, S, H, hd)    q/attn-out          — H or hd on model (attn_shard)
  btkk  (B, T, Hkv, hd)  k/v (+cache)        — kv heads if divisible; decode
                         caches may instead shard T on model (flash-decode,
                         ``shard_kv_seq``)
  btv   (B, S, Vp)       logits              — Vp on model
  gecd/gecf              MoE dispatch tensors

``batch_axes`` shards B; ``seq_axes`` optionally shards S (sequence
parallelism for long-context cells where B < mesh rows).

The port's mesh is a single controller: one process drives every device
and no tensor is split by a compiler.  So ``ShardingRules.act`` checks a
constraint (its guarded spec against the mesh) and returns the tensor
unchanged, and ``named_sharding_tree`` gives placements that are never
applied to a tensor.  The specs are what the dry run
(``launch/dryrun.py``) and the roofline's collective count
(``launch/roofline.py``) read.

Auction half.  The auction's launch paths
(``kernels/jasda_score/ops.py::score_variants``, ``kernels/wis_dp/ops.py``)
split rows over the mesh only when the guarded row spec still shards,
else they take the unsharded path.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import torch

__all__ = ["ShardingRules", "NamedSharding", "resolve_param_specs",
           "named_sharding_tree", "guard_spec", "mesh_size",
           "auction_row_spec", "replicated_spec", "spec_sharded",
           "row_shards", "row_slices", "sharded_launch"]


@dataclass(frozen=True)
class ShardingRules:
    mesh: Any  # launch.mesh.Mesh
    fsdp_axes: Tuple[str, ...] = ("data",)
    model_axes: Tuple[str, ...] = ("model",)
    batch_axes: Tuple[str, ...] = ("data",)
    seq_axes: Tuple[str, ...] = ()  # sequence parallelism (activations)
    attn_shard: str = "heads"  # heads | headdim (must match the config)
    kv_heads_shardable: bool = True
    shard_kv_seq: bool = False  # decode KV cache: T on model axis
    shard_moe_expert: bool = True  # experts on model (else expert-FFN dim)

    # -- helpers -------------------------------------------------------------
    def _b(self):
        return self.batch_axes if self.batch_axes else None

    def _s(self):
        return self.seq_axes if self.seq_axes else None

    def _m(self):
        return self.model_axes if self.model_axes else None

    def spec(self, kind: str) -> Tuple:
        b, s, m = self._b(), self._s(), self._m()
        # sequence parallelism shares the model axis: only the residual
        # stream (btd) carries the seq sharding; TP'd interiors drop it
        s_in = None if (s and m and set(s) & set(m)) else s
        if kind == "btd":
            return (b, s, None)
        if kind in ("btf", "btm"):
            return (b, s_in, m)
        if kind == "bshk":
            if self.attn_shard == "heads":
                return (b, s_in, m, None)
            return (b, s_in, None, m)
        if kind == "btkk":
            if self.shard_kv_seq:
                return (b, m, None, None)
            if self.attn_shard == "heads" and self.kv_heads_shardable:
                return (b, s_in, m, None)
            if self.attn_shard == "headdim":
                return (b, s_in, None, m)
            return (b, s_in, None, None)
        if kind == "btv":
            return (b, s_in, m)
        if kind == "bshk_seq":  # Ulysses interior: S on model, heads whole
            return (b, m, None, None)
        if kind == "btkk_full":  # Ulysses K/V: gathered heads + seq
            return (b, None, None, None)
        if kind == "xbtkk":  # stacked cross-attn K/V: (L, B, T, Hkv, hd)
            if self.attn_shard == "heads" and self.kv_heads_shardable:
                return (None, b, None, m, None)
            if self.attn_shard == "headdim":
                return (None, b, None, None, m)
            return (None, b, None, None, None)
        if kind == "gecd":
            return (b, m if self.shard_moe_expert else None, None, None)
        if kind == "gecf":
            return (b, m, None, None) if self.shard_moe_expert \
                else (b, None, None, m)
        raise ValueError(f"unknown activation kind {kind}")

    def act(self, x, kind: str):
        """Constrain ``x`` to activation ``kind``: the guarded spec is
        checked against the mesh and ``x`` is returned unchanged.  On the
        port's single-controller mesh a constraint has nothing to move in
        one process, so a model run with rules computes exactly what it
        computes without."""
        guard_spec(self.spec(kind), x.shape, self.mesh.shape)
        return x

    # -- parameter specs --------------------------------------------------------
    def resolve(self, logical: Tuple) -> Tuple:
        out = []
        for name in logical:
            if name is None:
                out.append(None)
            elif name == "fsdp":
                out.append(self.fsdp_axes if self.fsdp_axes else None)
            elif name == "model":
                out.append(self.model_axes if self.model_axes else None)
            else:
                raise ValueError(f"unknown logical axis {name}")
        return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec placed on a mesh: where a tensor of that spec would live.
    The port's counterpart of ``jax.sharding.NamedSharding``; nothing
    applies it to a tensor."""

    mesh: Any  # launch.mesh.Mesh
    spec: Tuple


def _map_specs(fn, tree):
    """``fn`` on every spec tuple of a nested dict (tuples are leaves)."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def resolve_param_specs(logical_tree, rules: ShardingRules):
    """Logical spec tuples → mesh spec tree."""
    return _map_specs(rules.resolve, logical_tree)


def named_sharding_tree(spec_tree, mesh):
    return _map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


def guard_spec(spec: Tuple, shape, mesh_shape: dict) -> Tuple:
    """Drop spec entries whose mesh extent does not divide the dim.

    Pure function; the result has one entry per dim of ``shape``.
    """
    cleaned = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            cleaned.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        size = 1
        for a in axes:
            size *= mesh_shape[a]
        cleaned.append(entry if dim % size == 0 else None)
    return tuple(cleaned)


def mesh_size(mesh) -> int:
    """Total device count of a mesh (1 for None -- the unsharded case)."""
    return 1 if mesh is None else len(mesh.devices)


def auction_row_spec(mesh, dim: int) -> Tuple:
    """Row-sharding spec for a leading auction dim (pooled bids / windows).

    Shards dim 0 over EVERY mesh axis, guarded by :func:`guard_spec`: when
    the mesh extent does not divide ``dim`` the entry is dropped and the
    spec degrades to replicated -- the caller then takes the unsharded
    launch path.  Bucketed round shapes (pow2 >= 256 bids, pow2 >= 8
    windows) always divide a pow2 auction mesh, so in practice the guard
    only fires on hand-built odd meshes.
    """
    return guard_spec((tuple(mesh.axis_names),), (dim,), mesh.shape)


def replicated_spec() -> Tuple:
    """The replicated (no-partition) spec for broadcast operands."""
    return ()


def spec_sharded(spec: Tuple) -> bool:
    """True when the spec actually partitions something."""
    return any(entry is not None for entry in tuple(spec))


def row_shards(mesh, rows: int) -> int:
    """Shard count for a launch over ``rows`` rows under ``mesh``
    (1 = unsharded: no mesh, one device, or a mesh that does not divide)."""
    n = mesh_size(mesh)
    if n <= 1 or not spec_sharded(auction_row_spec(mesh, rows)):
        return 1
    return n


def row_slices(mesh, n: int, rows: int) -> List[Tuple[torch.device, slice]]:
    """(device, row slice) of each of the ``n`` equal shards of ``rows``,
    in mesh order: shard k runs on ``mesh.devices[k]``."""
    step = rows // n
    return [(mesh.devices[k], slice(k * step, (k + 1) * step))
            for k in range(n)]


def _on_device(device: torch.device):
    """Context that makes ``device`` current for a launch (a no-op on the
    host): a kernel launches on the current card's current stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def sharded_launch(mesh, dev: torch.device, rows: int, split: dict,
                   whole: dict, launch: Callable) -> tuple:
    """``launch(**operands)`` once a row shard of ``mesh``, its outputs
    concatenated on ``dev``; once over all ``rows`` when the mesh does not
    shard them (:func:`row_shards`).

    ``split`` operands are cut by rows (contiguous views on their own
    device, copies on another); ``whole`` ones (None allowed) go whole to
    every shard's device.  Each shard launches with its device current.
    ``launch`` returns a tuple of tensors or Nones, the same in every shard.
    """
    n = row_shards(mesh, rows)
    if n == 1:
        return launch(**split, **whole)
    parts = []
    for shard_dev, cut in row_slices(mesh, n, rows):
        ops = {k: v[cut].to(shard_dev) for k, v in split.items()}
        ops.update({k: None if v is None else v.to(shard_dev)
                    for k, v in whole.items()})
        with _on_device(shard_dev):
            parts.append(launch(**ops))
    return tuple(None if parts[0][i] is None else
                 torch.cat([p[i].to(dev, non_blocking=True) for p in parts])
                 for i in range(len(parts[0])))

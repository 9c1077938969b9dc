"""Auction-round sharding: row specs over an auction mesh.

The auction half of ``repro/distributed/sharding.py``.  A spec is a plain
tuple with one entry per dim: ``None`` (replicated) or a tuple of mesh
axis names the dim is split over, as the entries of a
``jax.sharding.PartitionSpec`` are.  ``guard_spec`` drops entries whose
mesh extent does not divide the dim; the auction's launch paths
(``kernels/jasda_score/ops.py::score_variants``, ``kernels/wis_dp/ops.py``)
split rows over the mesh only when the guarded row spec still shards,
else they take the unsharded path.

The model half (``ShardingRules``, ``resolve_param_specs``,
``named_sharding_tree``) is not ported yet (``ROADMAP.md`` §1, item 7b).
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Tuple

import torch

__all__ = ["guard_spec", "mesh_size", "auction_row_spec", "replicated_spec",
           "spec_sharded", "row_shards", "row_slices", "sharded_launch"]


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

"""Production + auction mesh builders (assignment-fixed shapes).

The port's counterpart of ``repro/launch/mesh.py``.  A :class:`Mesh` is a
tuple of torch devices with named axes, driven from ONE process: the
round's control plane (scheduler, commit log) stays single, and only the
device work of a round is split across the mesh's devices, as the
reference's ``shard_map`` splits it.  Devices may repeat: ``["cpu"] * 4``
or ``[torch.device("cuda", 0)] * 4`` give four virtual shards on one
device (the counterpart of the reference's ``JASDA_FORCE_HOST_DEVICES``),
which is how the sharded path is tested on a host and on one card.

``make_auction_mesh`` is the entry point the sharded auction round uses
(``SchedulerConfig.mesh`` / the ``mesh=`` knob on ``clear_round`` /
``pipelined_clear_rounds``): a 1-axis mesh named ``"bids"`` over a
power-of-two device count, clamped to what the machine has.  Building a
mesh touches no device state beyond counting cards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..kernels.common import resolve_device

__all__ = ["Mesh", "make_production_mesh", "make_auction_mesh", "mesh_chips",
           "AUCTION_AXIS"]

#: the single mesh axis the auction shards over: the pooled bid dim of the
#: scoring launch and the window dim of the batched WIS settle
AUCTION_AXIS = "bids"


@dataclass(frozen=True)
class Mesh:
    """Devices laid out over named axes (row-major over ``dims``).

    ``shape`` maps each axis to its size, as ``jax.sharding.Mesh.shape``
    does.  Frozen and hashable; the same device may appear more than once
    (virtual shards).
    """

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.dims):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.dims)} dims")
        n = 1
        for d in self.dims:
            n *= int(d)
        if n != len(self.devices) or n < 1:
            raise ValueError(f"mesh dims {self.dims} need {n} devices, got "
                             f"{len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))


def _pow2_floor(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


def _device_list(devices: Optional[Sequence]) -> Tuple[torch.device, ...]:
    """Resolved devices; None = every visible CUDA card (raises without
    one, as ``resolve_device`` does).  A bare ``"cuda"`` is pinned to the
    current card so every shard names the device it runs on."""
    if devices is None:
        resolve_device(None)
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return tuple(out)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """Single pod: (data=16, model=16) = 256 devices.
    Multi-pod:   (pod=2, data=16, model=16) = 512 devices.

    Falls back to a 1-axis ``("data",)`` mesh over every device given when
    the fixed shape exceeds them.  ``devices`` None takes the visible CUDA
    cards and raises without one, as :func:`make_auction_mesh` does; a
    host mesh exists only when the caller names ``"cpu"``.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = _device_list(devices)
    n_needed = 1
    for s in shape:
        n_needed *= s
    if len(devs) < n_needed:
        return Mesh(devs, ("data",), (len(devs),))
    return Mesh(devs[:n_needed], axes, shape)


def make_auction_mesh(n_shards: Optional[int] = None, *,
                      devices=None) -> Mesh:
    """A 1-axis auction mesh over ``n_shards`` devices (axis ``"bids"``).

    ``devices`` None takes every visible CUDA card and raises without one
    (the port never moves a device run to the host unasked); an explicit
    sequence (``["cpu"] * 4``, ``[torch.device("cuda", 0)] * 4``) builds
    virtual shards.  ``n_shards=None`` takes every device given.  The shard
    count is clamped to the largest power of two <= min(requested,
    available) so pow2-bucketed round shapes (``bucket_m``, core/wis row
    buckets) always divide evenly across shards.  With one device (or
    ``n_shards=1``) the mesh is valid but degenerate; every ``mesh=``
    consumer then takes the unsharded launch path.
    """
    devs = _device_list(devices)
    avail = len(devs)
    n = avail if n_shards is None else min(int(n_shards), avail)
    n = _pow2_floor(max(n, 1))
    return Mesh(devs[:n], (AUCTION_AXIS,), (n,))


def mesh_chips(mesh: Mesh) -> int:
    """The mesh's device count (virtual shards counted each)."""
    return len(mesh.devices)

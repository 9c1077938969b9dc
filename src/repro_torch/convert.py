"""Carry the reference's state into the port.

A scheduler has no weights; what a run carries is its packed round
arrays, its calibration trust state and its policy.  These helpers read
the reference objects' dataclass fields and numpy arrays -- never importing
the ``repro`` package -- and rebuild the port's objects from them:

* :func:`packed_round` — a reference ``PackedRound`` (numpy) → the port's
  ``PackedRound`` of float32 torch tensors on a device, the dtypes the
  scoring kernel consumes;
* :func:`settle_arrays` — the packed ``(W, L)`` settle layout (numpy) →
  the int32 / bool / float32 tensors the settle kernel consumes;
* :func:`calibrator` — a reference ``Calibrator`` (or its ``snapshot()``)
  → the port's ``Calibrator``;
* :func:`to_port` — any reference dataclass value (``Policy``,
  ``ScoringPolicy``, clearing backends, ...) → the port's twin.

The tests use them to feed both packages the same inputs.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Mapping, Optional

import numpy as np
import torch

from .kernels.common import resolve_device

__all__ = ["to_port", "policy", "calibrator", "packed_round", "settle_arrays"]

_REF = "repro"
_PORT = "repro_torch"


def _port_class(cls: type) -> type:
    mod = cls.__module__
    if mod != _REF and not mod.startswith(_REF + "."):
        raise TypeError(f"{cls.__qualname__} from {mod} is not a reference type")
    port_mod = importlib.import_module(_PORT + mod[len(_REF):])
    return getattr(port_mod, cls.__qualname__)


def to_port(obj):
    """Rebuild a reference value with the port's classes, field by field."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        if cls.__module__.startswith(_PORT):
            return obj
        kw = {f.name: to_port(getattr(obj, f.name))
              for f in dataclasses.fields(obj) if f.init}
        return _port_class(cls)(**kw)
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_port(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_port(v) for v in obj)
    return obj


def policy(ref_policy):
    """A reference ``Policy`` → the port's ``Policy``."""
    return to_port(ref_policy)


def calibrator(ref, config=None):
    """A reference ``Calibrator`` (or its ``snapshot()``) → the port's.

    ``config`` overrides the calibration config; by default it is the
    reference calibrator's own (or the port's default for a bare snapshot).
    """
    from .core.calibration import CalibrationConfig, Calibrator

    if isinstance(ref, Mapping):
        snap = ref
        cfg = config if config is not None else CalibrationConfig()
    else:
        snap = ref.snapshot()
        cfg = config if config is not None else to_port(ref.config)
    return Calibrator(cfg).restore(snap)


def packed_round(packed, device=None):
    """A reference ``PackedRound`` → the port's, as float32 device tensors."""
    from .kernels.jasda_score.ops import PackedRound

    dev = resolve_device(device)
    return PackedRound(*(
        torch.from_numpy(np.ascontiguousarray(getattr(packed, f), np.float32)).to(dev)
        for f in PackedRound._fields))


def settle_arrays(idx_sorted, pred, weights: Optional[np.ndarray] = None,
                  device=None) -> dict:
    """The packed (W, L) settle layout → the settle kernel's tensors.

    ``idx_sorted`` holds pool indices (−1 on padded lanes); the lane mask
    is ``idx_sorted >= 0``.  Returns ``idx`` int32, ``mask`` bool, ``pred``
    int32 and, when given, ``weights`` float32.
    """
    dev = resolve_device(device)
    idx = np.asarray(idx_sorted)
    out = {
        "idx": torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(dev),
        "mask": torch.from_numpy(np.ascontiguousarray(idx >= 0)).to(dev),
        "pred": torch.from_numpy(np.ascontiguousarray(pred, np.int32)).to(dev),
    }
    if weights is not None:
        out["weights"] = torch.from_numpy(
            np.ascontiguousarray(weights, np.float32)).to(dev)
    return out

"""Sharded, atomic, async checkpointing of torch and numpy trees.

Layout:  <dir>/step_<N>/
            manifest.json            — tree structure, shapes, dtypes
            shard_<i>.npz            — flattened leaves (chunked)
         <dir>/step_<N>.tmp/ → atomic rename on commit

The on-disk format is the reference store's (``repro/checkpoint/store.py``),
so a checkpoint written by either restores in the other:

  * a tree is flattened in JAX's pytree leaf order — dict keys sorted,
    lists, tuples and namedtuples in order, ``None`` no leaf, anything
    else one leaf (:func:`tree_flatten`);
  * numpy cannot store bfloat16 or the float8 types: their raw bits are
    saved (bf16 as uint16, float8 as uint8) under the logical dtype name
    in the manifest;
  * the manifest's ``treedef`` string is informative only: neither store
    reads it back;
  * write happens in a background thread (``wait()`` joins before the
    next save — bounded staleness of one);
  * atomic rename + "latest" pointer file makes partially-written
    checkpoints invisible to restore; restart auto-resumes from the newest
    complete step.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from collections import OrderedDict
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

# numpy cannot savez bf16/f8 arrays: store them as raw uint views and
# record the logical dtype in the manifest.  name → (torch dtype, numpy
# dtype of the stored bits, a numpy dtype of that width torch reads)
_EXT_DTYPES = {"bfloat16": (torch.bfloat16, np.uint16, np.int16),
               "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, np.uint8),
               "float8_e5m2": (torch.float8_e5m2, np.uint8, np.uint8)}
_EXT_NAMES = {v[0]: k for k, v in _EXT_DTYPES.items()}


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


__all__ = ["CheckpointStore", "CheckpointError", "tree_flatten"]


class CheckpointError(RuntimeError):
    """A checkpoint exists but cannot be loaded (truncated/corrupt blob).

    Distinct from :class:`FileNotFoundError` (no checkpoint at all): a
    caller seeing this should fall back to an OLDER step rather than
    cold-start — the store's atomic-rename protocol makes this rare
    (a half-written step is never visible), but torn disks happen.
    """


def tree_flatten(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """Leaves of ``tree`` in JAX's pytree order, and their unflatten.

    dict keys are visited sorted (an ``OrderedDict`` in its own order),
    lists, tuples and namedtuples in order; ``None`` holds no leaf; any
    other value is one leaf.  ``unflatten(leaves)`` rebuilds the same
    structure around new leaves.  The unflatten holds no reference to the
    leaves, so dropping them frees them at once (no reference cycle waits
    for the garbage collector: a leaf may be a large device tensor).
    """
    leaves: List[Any] = []
    rebuild = _build(tree, leaves)
    return leaves, lambda new: rebuild(iter(new))


def _build(node, leaves: List[Any]):
    """Append ``node``'s leaves to ``leaves``; return its rebuild function."""
    if node is None:
        return lambda it: None
    if isinstance(node, dict):
        keys = list(node) if isinstance(node, OrderedDict) else sorted(node)
        subs = [_build(node[k], leaves) for k in keys]
        kind = type(node)
        return lambda it: kind((k, sub(it)) for k, sub in zip(keys, subs))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        subs = [_build(v, leaves) for v in node]
        kind = type(node)
        return lambda it: kind(*(sub(it) for sub in subs))
    if isinstance(node, (list, tuple)):
        subs = [_build(v, leaves) for v in node]
        kind = type(node)
        return lambda it: kind(sub(it) for sub in subs)
    leaves.append(node)
    return lambda it: next(it)


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array stored on disk, and its logical dtype."""
    if isinstance(leaf, torch.Tensor):
        # a copy, so an in-place update after save() cannot reach the write
        t = leaf.detach().to("cpu", copy=True)
        name = _EXT_NAMES.get(t.dtype)
        if name is not None:
            _, stored, readable = _EXT_DTYPES[name]
            return t.view(_torch_dtype(readable)).numpy().view(stored), name
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, logical: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its logical dtype."""
    if logical in _EXT_DTYPES:
        dtype, _, readable = _EXT_DTYPES[logical]
        return torch.from_numpy(np.ascontiguousarray(a).view(readable)).view(dtype)
    return torch.from_numpy(np.ascontiguousarray(a))


def _cast_like(a: np.ndarray, logical: str, template: Any) -> Any:
    """A stored leaf cast to ``template``'s dtype, shape and device."""
    if isinstance(template, torch.Tensor):
        return _to_tensor(a, logical).to(template.dtype).reshape(
            template.shape).to(template.device)
    if hasattr(template, "dtype"):  # a numpy array or scalar
        return _to_tensor(a, logical).to(_torch_dtype(template.dtype)).reshape(
            np.shape(template)).numpy()
    # no dtype to cast to: the stored array (ext dtypes as tensors)
    return _to_tensor(a, logical) if logical in _EXT_DTYPES else a


class CheckpointStore:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        self.wait()
        leaves, _ = tree_flatten(tree)
        hosted = [_to_host(x) for x in leaves]
        host_leaves = [a for a, _ in hosted]
        logical_dtypes = [name for _, name in hosted]
        treedef_str = f"PyTreeDef(torch, {len(host_leaves)} leaves)"

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shard_0.npz"),
                     **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
            manifest = {
                "step": step,
                "n_leaves": len(host_leaves),
                "treedef": treedef_str,
                "shapes": [list(a.shape) for a in host_leaves],
                "dtypes": logical_dtypes,
                "hosts": {"0": list(range(len(host_leaves)))},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            with open(os.path.join(self.dir, "latest.tmp"), "w") as f:
                f.write(str(step))
            os.replace(os.path.join(self.dir, "latest.tmp"),
                       os.path.join(self.dir, "latest"))
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def save_state(self, step: int, state: Any, *, blocking: bool = True) -> None:
        """Checkpoint an arbitrary picklable OBJECT graph (scheduler state).

        The array path (:meth:`save`) flattens a tree; scheduler crash
        recovery instead needs one pickled graph so shared object
        IDENTITIES (the same Variant held by a commitment, the running
        set, and the commit index) survive the round-trip.  Same
        atomicity: written to ``step_<N>.tmp`` and renamed into place, so
        a crash mid-write never leaves a half checkpoint visible;
        ``latest`` and GC are shared with the array path.
        """
        import pickle

        self.wait()
        blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, "state.pkl"), "wb") as f:
                f.write(blob)
            manifest = {"step": step, "kind": "pickle",
                        "n_bytes": len(blob)}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            with open(os.path.join(self.dir, "latest.tmp"), "w") as f:
                f.write(str(step))
            os.replace(os.path.join(self.dir, "latest.tmp"),
                       os.path.join(self.dir, "latest"))
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def restore_state(self, step: Optional[int] = None) -> Tuple[Any, int]:
        """Load a :meth:`save_state` checkpoint (latest when ``step`` None)."""
        import pickle

        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        final = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(final, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("kind") != "pickle":
            raise ValueError(
                f"step {step} is an array checkpoint; use restore()")
        blob_path = os.path.join(final, "state.pkl")
        try:
            with open(blob_path, "rb") as f:
                blob = f.read()
            expected = manifest.get("n_bytes")
            if expected is not None and len(blob) != expected:
                raise CheckpointError(
                    f"step {step}: state.pkl is {len(blob)} bytes, "
                    f"manifest says {expected} (truncated write?)")
            return pickle.loads(blob), step
        except (EOFError, pickle.UnpicklingError, AttributeError,
                ImportError, IndexError) as e:
            # pickle raises a zoo of exceptions on corrupt input; surface
            # one typed error so restart logic can fall back to an older
            # step instead of crashing on a bare EOFError
            raise CheckpointError(
                f"step {step}: corrupt checkpoint blob ({e})") from e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "latest")
        if os.path.exists(path):
            with open(path) as f:
                s = int(f.read().strip())
            if os.path.exists(os.path.join(self.dir, f"step_{s}", "manifest.json")):
                return s
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Tuple[Any, int]:
        """Restore into the structure of ``template`` (shapes must match).

        Each leaf is cast to the template leaf's dtype and, for a tensor,
        put on the template leaf's device; a numpy template leaf comes
        back as a numpy array.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        final = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(final, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(final, "shard_0.npz"))
        leaves = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
        flat_t, unflatten = tree_flatten(template)
        if len(flat_t) != len(leaves):
            raise ValueError(f"checkpoint/template mismatch: step {step} "
                             f"holds {len(leaves)} leaves, the template "
                             f"{len(flat_t)}")
        restored = [_cast_like(a, logical, t) for a, logical, t
                    in zip(leaves, manifest["dtypes"], flat_t)]
        return unflatten(restored), step

"""Multi-pod dry run on meta tensors: every (arch × shape × mesh) cell.

The port's counterpart of ``repro/launch/dryrun.py``.  The reference
lowers and compiles each cell through XLA on 512 placeholder host devices;
the port runs it on the ``meta`` device, where a tensor has a shape and a
dtype and no data, so nothing is allocated and no kernel launches:

  * the model, its params, the optimizer state and every input of the
    cell's function (``configs.shapes.input_specs``) are built on meta at
    full width, and the production mesh over meta placeholders;
  * the cell's function -- the train step with the reference's
    microbatch and remat choices, ``prefill`` or ``decode_step`` -- runs
    under ``torch.utils.flop_counter.FlopCounterMode``.  Each superblock
    of the stack does the same work, so the function runs at one and at
    two superblocks (the tail and the rest at full width) and the count is
    extrapolated to the full depth; a train step runs one microbatch and
    is multiplied by their count (the port's step loops over identical
    microbatches).

Per cell this records the reference's row (``Roofline.row()`` keys,
``t_lower_s``, ``cost_detail``): flops and bytes from
``costmodel.analytic_cost``, as the reference's; collectives from the
rules (``roofline.collective_bytes_from_rules``); ``memory`` with
``argument_bytes`` the per-device bytes of every input leaf (each leaf's
bytes over the mesh extent of its guarded spec).  No compiler plans the
cell, so ``temp_bytes``, ``output_bytes`` and ``alias_bytes`` are None.
``flop_counter`` holds the meta run's count, the cross-check of the
analytic count.  Rows are appended to --out (incremental: reruns skip
finished cells).

Usage:
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
      --out results/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_NAMES, SHAPES, get, info as arch_info, input_specs
from ..distributed.sharding import (ShardingRules, guard_spec,
                                    resolve_param_specs)
from ..models.model import Model
from ..training.optimizer import adafactor, adamw
from ..training.schedule import warmup_cosine
from ..training.trainer import make_accum_steps, make_train_step
from .costmodel import analytic_cost
from .mesh import make_production_mesh, mesh_chips
from .roofline import Roofline, collective_bytes_from_rules, model_flops

__all__ = ["run_cell", "lower_cell", "build_rules", "flop_counter_band",
           "main", "LoweredCell"]

META = torch.device("meta")


def _fit_axes(batch: int, candidates, mesh) -> tuple:
    """Largest candidate axis tuple whose extent divides the batch."""
    for axes in candidates:
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if size and batch % size == 0:
            return axes
    return ()


def build_rules(cfg, info, shape, mesh, *, multi_pod: bool,
                overrides: Optional[dict] = None) -> ShardingRules:
    fsdp = ("pod", "data") if multi_pod else ("data",)
    full = fsdp + ("model",)
    if info.pure_dp and shape.kind in ("train", "prefill"):
        # tiny model: replicate params, batch over as much mesh as divides
        batch_axes = _fit_axes(shape.batch, [full, fsdp, ("data",)], mesh)
        kw = dict(mesh=mesh, fsdp_axes=(), model_axes=(),
                  batch_axes=batch_axes, attn_shard=cfg.attn_shard,
                  kv_heads_shardable=False, shard_kv_seq=False,
                  shard_moe_expert=False)
    else:
        batch_axes = _fit_axes(shape.batch, [fsdp, ("data",)], mesh)
        infer_repl = info.infer_replicate_fsdp and shape.kind != "train"
        kw = dict(
            mesh=mesh,
            fsdp_axes=() if infer_repl else fsdp,
            batch_axes=batch_axes,
            seq_axes=(("model",) if (info.seq_shard_train and
                                     shape.kind == "train") else ()),
            attn_shard=cfg.attn_shard,
            kv_heads_shardable=(cfg.n_kv_heads % cfg.model_axis_size == 0),
            shard_kv_seq=(info.decode_shard_kv_seq and shape.kind == "decode"),
            shard_moe_expert=(cfg.moe_shard == "expert"),
        )
    if overrides:
        kw.update(overrides)
    return ShardingRules(**kw)


def _map2(fn, a, b):
    """``fn`` over two trees shaped alike (dicts; spec tuples are leaves)."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _opt_spec_tree(opt_name: str, param_specs_resolved, params):
    """Optimizer-state specs mirroring the params."""
    if opt_name == "adamw":
        return {"m": param_specs_resolved, "v": param_specs_resolved}

    def fact(spec, p):
        if len(p.shape) >= 2:
            t = tuple(spec)
            t = t + (None,) * (len(p.shape) - len(t))
            return {"vr": t[:-1], "vc": t[:-2] + t[-1:]}
        return {"v": tuple(spec)}

    return {"stats": _map2(fact, param_specs_resolved, params)}


def make_optimizer(name: str):
    lr = warmup_cosine(3e-4, 200, 10000)
    return adamw(lr) if name == "adamw" else adafactor(lr)


def _microbatches(info, shape, rules, mesh, override: Optional[int]) -> int:
    """The train step's microbatch count: each must still cover the
    batch-sharded mesh rows."""
    mb = override or info.microbatches.get(shape.name, 1)
    n_rows = 1
    for a in rules.batch_axes:
        n_rows *= mesh.shape[a]
    if n_rows:
        mb = max(1, min(mb, shape.batch // n_rows))
    return mb


def _cut(cfg, k: int):
    """``cfg`` with ``k`` superblocks in its stack (its tail kept; an
    encoder cut to ``k`` layers alike)."""
    kw = {"n_layers": k * len(cfg.superblock) + cfg.n_tail}
    if cfg.family == "encdec":
        if cfg.n_encoder_layers != cfg.n_super:
            raise ValueError("the depth extrapolation needs as many encoder "
                             "as decoder layers")
        kw["n_encoder_layers"] = k
    return cfg.replace(**kw)


def _meta_like(params, dtype):
    """A meta tree shaped like ``params`` in ``dtype`` (a gradient
    accumulator)."""
    return _map2(lambda p, _: torch.empty(p.shape, dtype=dtype, device=META),
                 params, params)


def _metas(tree):
    """Meta tensors for a tree of TensorSpecs."""
    if isinstance(tree, dict):
        return {k: _metas(v) for k, v in tree.items()}
    return tree.meta()


def _count_flops(cfg, info, shape, rules, impl, mb, kv_dtype) -> float:
    """FLOPs ``FlopCounterMode`` counts over one run of the cell's function
    on meta tensors (a train step: one microbatch of ``mb``)."""
    model = Model(cfg)
    params = model.init(device=META)
    args = _metas(input_specs(cfg, shape, rules, kv_dtype=kv_dtype))
    with FlopCounterMode(display=False) as counter:
        if shape.kind == "train":
            micro = {k: torch.empty((shape.batch // mb,) + tuple(v.shape[1:]),
                                    dtype=v.dtype, device=META)
                     for k, v in args.items()}
            opt = make_optimizer(info.optimizer)
            accum_dtype = getattr(torch, info.grad_accum_dtype)
            if info.external_accum:
                micro_step, _ = make_accum_steps(
                    model, opt, rules=rules, attn_impl=impl, remat=True,
                    accum_dtype=accum_dtype, microbatches=mb)
                micro_step(params, _meta_like(params, accum_dtype), micro)
            else:
                step = make_train_step(model, opt, rules=rules, microbatches=1,
                                       attn_impl=impl, remat=True,
                                       accum_dtype=accum_dtype)
                step(params, opt.init(params), micro, 0)
        else:
            with torch.no_grad():
                if shape.kind == "prefill":
                    model.prefill(params, args["tokens"],
                                  memory=args.get("memory"), rules=rules,
                                  impl=impl)
                else:
                    model.decode_step(params, args["token"], args["index"],
                                      args["cache"],
                                      cross_stack=args.get("cross_stack"),
                                      rules=rules, impl=impl)
    return float(counter.get_total_flops()) * (mb if shape.kind == "train" else 1)


def flop_counter_band(cfg, shape):
    """``(lo, hi, why)``: where the meta run's FLOP count must fall, as a
    fraction of ``analytic_cost``'s, and why it is not 1.  The counter sees
    only matmuls, and it counts what the port runs."""
    moe = cfg.family == "moe"
    dispatch = ("; the port scatters tokens to their expert slots where the "
                "model counts one-hot dispatch and combine einsums")
    if shape.kind == "train":
        why = ("the unembed runs 3 passes outside remat where the model counts "
               "4, and torch's checkpoint stops its recompute at the last "
               "saved tensor (a block's output projection is not re-run)")
        return (0.65, 0.9, why + dispatch) if moe else (0.85, 1.0, why)
    if shape.kind == "prefill":
        why = "a prefill unembeds its last position only"
        if moe:
            return 0.8, 0.95, why + dispatch
        if cfg.family == "hybrid":
            return 1.0, 1.4, (why + "; chunked attention computes all S x T "
                              "logits and masks the window, where the model "
                              "bounds the context by the window")
        return 0.9, 1.0, why
    if moe:
        return 1.0, 2.5, ("a decode step routes groups of one token, capacity "
                          "1, so every expert runs one slot a token; the model "
                          "takes 512-token groups")
    return 0.99, 1.0 + 1e-9, "the recurrent state update is elementwise"


@dataclass
class LoweredCell:
    """What the port's dry run knows of a cell: the per-device bytes of
    each of its function's arguments, and the FLOPs the meta run counted
    at full depth."""

    argument_bytes: Dict[str, float]
    flops_global: float
    microbatches: int
    impl: str


def _per_device_bytes(shape, dtype, spec, mesh) -> float:
    spec = guard_spec(spec, shape, mesh.shape)
    extent = 1
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            extent *= mesh.shape[a]
    return math.prod(shape) * dtype.itemsize / extent


def _tree_bytes(values, specs, mesh) -> float:
    """Per-device bytes of a tree of tensors with its spec tree."""
    if isinstance(values, dict):
        return sum(_tree_bytes(values[k], specs[k], mesh) for k in values)
    return _per_device_bytes(values.shape, values.dtype, specs, mesh)


def _input_bytes(tree, mesh) -> float:
    """Per-device bytes of a tree of TensorSpecs."""
    if isinstance(tree, dict):
        return sum(_input_bytes(v, mesh) for v in tree.values())
    return _per_device_bytes(tree.shape, tree.dtype, tree.sharding.spec, mesh)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               rule_overrides: Optional[dict] = None,
               attn_impl: Optional[str] = None,
               microbatch_override: Optional[int] = None):
    cfg, info = get(arch), arch_info(arch)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not info.long_context:
        return None  # recorded as an explicit skip by the caller
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=[META] * (512 if multi_pod else 256))
    rules = build_rules(cfg, info, shape, mesh, multi_pod=multi_pod,
                        overrides=rule_overrides)
    model = Model(cfg)
    pspecs = resolve_param_specs(model.specs(), rules)
    params = model.init(device=META)
    kv_dtype = (info.kv_cache_dtype if shape.kind == "decode" else None)
    specs = input_specs(cfg, shape, rules, kv_dtype=kv_dtype)
    impl = attn_impl or (
        info.train_attn_impl if (shape.kind == "train" and
                                 info.train_attn_impl != "auto")
        else ("chunked" if shape.seq > 8192 else "auto"))

    args = {"params": _tree_bytes(params, pspecs, mesh)}
    mb = 1
    if shape.kind == "train":
        mb = _microbatches(info, shape, rules, mesh, microbatch_override)
        if info.external_accum:
            # the micro step's arguments: params, the gradient accumulator
            # (params' specs, accum dtype) and one microbatch
            accum = getattr(torch, info.grad_accum_dtype)
            args["grad_acc"] = _tree_bytes(_meta_like(params, accum), pspecs,
                                           mesh)
            args["batch"] = _input_bytes(specs, mesh) / mb
        else:
            opt = make_optimizer(info.optimizer)
            args["opt_state"] = _tree_bytes(
                opt.init(params), _opt_spec_tree(info.optimizer, pspecs, params),
                mesh)
            args["batch"] = _input_bytes(specs, mesh)
    else:
        args["inputs"] = _input_bytes(specs, mesh)

    n_super = cfg.n_super
    f1 = _count_flops(_cut(cfg, 1), info, shape, rules, impl, mb, kv_dtype)
    f2 = (_count_flops(_cut(cfg, 2), info, shape, rules, impl, mb, kv_dtype)
          if n_super > 1 else f1)
    flops = f1 + (n_super - 1) * (f2 - f1)
    return LoweredCell(args, flops, mb, impl), cfg, info, shape, mesh, rules


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             rule_overrides: Optional[dict] = None,
             attn_impl: Optional[str] = None,
             microbatch_override: Optional[int] = None,
             verbose: bool = True) -> Optional[dict]:
    t0 = time.time()
    out = lower_cell(arch, shape_name, multi_pod=multi_pod,
                     rule_overrides=rule_overrides, attn_impl=attn_impl,
                     microbatch_override=microbatch_override)
    if out is None:
        row = {"arch": arch, "shape": shape_name,
               "mesh": "multi" if multi_pod else "single",
               "skipped": "full attention at 524k seq is quadratic "
                          "(DESIGN §Arch-applicability)"}
        if verbose:
            print(f"[skip] {arch} × {shape_name}: {row['skipped']}")
        return row
    cell, cfg, info, shape, mesh, rules = out
    t_lower = time.time() - t0

    chips = mesh_chips(mesh)
    coll = collective_bytes_from_rules(cfg, info, shape, rules)
    mem_stats = {
        "argument_bytes": sum(cell.argument_bytes.values()),
        "output_bytes": None,
        "temp_bytes": None,
        "alias_bytes": None,
    }
    ac = analytic_cost(cfg, info, shape,
                       attn_impl=(attn_impl or
                                  ("chunked" if shape.seq > 8192 else "full")))
    params_replicated = info.pure_dp and shape.kind in ("train", "prefill")
    rl = Roofline(
        arch=arch, shape=shape_name,
        mesh="multi" if multi_pod else "single", chips=chips,
        flops_per_device=ac.flops_global / chips,
        bytes_per_device=ac.bytes_per_device(
            chips, params_replicated=params_replicated),
        collective=coll,
        model_flops_global=model_flops(cfg, shape),
        memory_stats=mem_stats,
    )
    row = rl.row()
    row.update({"t_lower_s": round(t_lower, 1),
                "flop_counter": {"flops_global": cell.flops_global,
                                 "attn_impl": cell.impl,
                                 "microbatches": cell.microbatches},
                "argument_bytes_by_input": cell.argument_bytes,
                "cost_detail": ac.detail})
    if verbose:
        print(f"[ok] {arch} × {shape_name} × {row['mesh']}: "
              f"args/dev={mem_stats['argument_bytes']/2**30:.2f}GiB "
              f"flops/dev={row['flops_per_device']:.3e} "
              f"t_comp={row['t_compute_s']*1e3:.2f}ms "
              f"t_mem={row['t_memory_s']*1e3:.2f}ms "
              f"t_coll={row['t_collective_s']*1e3:.2f}ms "
              f"bottleneck={row['bottleneck']} "
              f"flop_counter/analytic="
              f"{cell.flops_global / ac.flops_global:.4f} "
              f"(lower {t_lower:.1f}s)")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
                except (json.JSONDecodeError, KeyError):
                    pass

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = (arch, shape, "multi" if mp else "single")
                if key in done:
                    print(f"[cached] {key}")
                    continue
                try:
                    row = run_cell(arch, shape, multi_pod=mp)
                except Exception as e:  # record the cell, go on to the next
                    traceback.print_exc()
                    failures.append((key, str(e)))
                    row = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "error": str(e)[:2000]}
                if row is not None:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(row) + "\n")
    if failures:
        print(f"\n{len(failures)} FAILED cells:")
        for k, e in failures:
            print(" ", k, e[:200])
        sys.exit(1)
    print("\nall requested cells passed")


if __name__ == "__main__":
    main()

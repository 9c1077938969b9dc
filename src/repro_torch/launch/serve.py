"""Serving launcher: continuous-batching engine for any decoder-only arch
of ``configs.registry.PORTED``; the ``encdec`` and ``vlm`` configs are
refused as the reference refuses them (the engine has no memory input;
``Model.prefill(memory=)`` and ``decode_step(cross_stack=)`` drive them).

The port's counterpart of ``repro/launch/serve.py``, with the same flags
plus ``--device`` (``cuda`` unless ``cpu`` is asked for) and
``--attn-impl``, the attention of each prefill: the reference's own
``Model.prefill(impl=...)`` argument carried through to the launcher
(``pallas`` or its alias ``cuda`` runs the flash-attention kernel K4 on
the card; decode keeps ``auto``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon_mamba_7b \
        --reduced --device cpu
    python -m repro_torch.launch.serve --arch olmoe_1b_7b \
        --attn-impl pallas
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..configs import get, reduced
from ..kernels.common import resolve_device
from ..models import Model
from ..serving import Request, ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for params init and synthetic prompts")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda or cpu)")
    ap.add_argument("--attn-impl", default="auto",
                    choices=("auto", "full", "chunked", "pallas", "cuda"),
                    help="attention of each prefill (decode keeps auto)")
    ap.add_argument("--json", action="store_true",
                    help="emit a machine-readable result line")
    args = ap.parse_args(argv)

    cfg = reduced(args.arch) if args.reduced else get(args.arch)
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit("serve.py demo drives decoder-only archs; "
                         "enc-dec/vlm serving needs a memory input per "
                         "request (see serving.engine prefill hooks)")
    device = resolve_device(args.device)
    model = Model(cfg)
    params = model.init(args.seed, device=device)
    eng = ServingEngine(model, params, ServeConfig(
        batch_slots=args.slots, max_seq=args.max_seq), device=device,
        attn_impl=args.attn_impl)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, args.max_seq // 4))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        reqs.append(Request(f"r{i:03d}", prompt, max_new_tokens=args.max_new))
        eng.submit(reqs[-1])
    t0 = time.perf_counter()
    eng.run_until_done()
    wall = time.perf_counter() - t0
    toks = sum(len(r.output) for r in reqs)
    stuck = [r.request_id for r in reqs if not r.done]
    if args.json:
        print(json.dumps({
            "arch": cfg.name, "seed": args.seed, "device": str(device),
            "attn_impl": args.attn_impl,
            "requests": len(reqs), "tokens": toks, "wall_s": round(wall, 4),
            "tok_per_s": round(toks / wall, 2) if wall > 0 else None,
            "unfinished": stuck,
        }))
    else:
        print(f"{cfg.name}: {len(reqs)} requests, {toks} tokens in {wall:.2f}s "
              f"({toks/wall:.1f} tok/s) on {device}")
    if stuck:
        print(f"error: {len(stuck)} request(s) never finished: "
              f"{', '.join(stuck)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

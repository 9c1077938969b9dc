"""Generate the §Dry-run / §Roofline tables from a dry run's jsonl.

The port's copy of ``repro/launch/report.py``: the same tables, byte for
byte, from the rows ``launch/dryrun.py`` writes.

Usage: python -m repro_torch.launch.report results/dryrun.jsonl > tables.md
"""
from __future__ import annotations

import json
import sys
from collections import defaultdict


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/2**30:.2f}"


def fmt_t(t):
    if t is None:
        return "-"
    if t >= 1.0:
        return f"{t:.2f}s"
    return f"{t*1e3:.2f}ms"


def load(path):
    rows = {}
    for line in open(path):
        try:
            r = json.loads(line)
        except json.JSONDecodeError:
            continue
        rows[(r["arch"], r["shape"], r["mesh"])] = r  # last write wins
    return rows


def main(path):
    rows = load(path)
    archs, shapes = [], ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    for (a, _, _) in rows:
        if a not in archs:
            archs.append(a)

    print("### §Dry-run — lower+compile per (arch × shape × mesh)\n")
    print("| arch | shape | mesh | status | mem/dev GiB (args+temps) | "
          "collectives (n) | lower+compile s |")
    print("|---|---|---|---|---|---|---|")
    for a in archs:
        for s in shapes:
            for m in ("single", "multi"):
                r = rows.get((a, s, m))
                if r is None:
                    print(f"| {a} | {s} | {m} | MISSING | | | |")
                    continue
                if "skipped" in r:
                    print(f"| {a} | {s} | {m} | skip (quadratic@524k) | | | |")
                    continue
                if "error" in r:
                    print(f"| {a} | {s} | {m} | ERROR | | | |")
                    continue
                mem = r.get("memory") or {}
                dev = (mem.get("argument_bytes") or 0) + (mem.get("temp_bytes") or 0)
                print(f"| {a} | {s} | {m} | ok | {dev/2**30:.2f} | "
                      f"{r.get('n_collectives','-')} | "
                      f"{r.get('t_lower_s',0)}+{r.get('t_compile_s',0)} |")
    print()

    print("### §Roofline — three terms per cell (single-pod, 256 chips)\n")
    print("| arch | shape | t_comp | t_mem | t_coll | bottleneck | "
          "MODEL/HLO | roofline frac | note |")
    print("|---|---|---|---|---|---|---|---|---|")
    for a in archs:
        for s in shapes:
            r = rows.get((a, s, "single"))
            if r is None or "error" in r:
                continue
            if "skipped" in r:
                print(f"| {a} | {s} | - | - | - | skipped | - | - | "
                      f"full attention is quadratic at 524k |")
                continue
            note = _note(r)
            print(f"| {a} | {s} | {fmt_t(r['t_compute_s'])} | "
                  f"{fmt_t(r['t_memory_s'])} | {fmt_t(r['t_collective_s'])} | "
                  f"{r['bottleneck']} | {r['model_vs_hlo']:.2f} | "
                  f"{r['roofline_fraction']:.3f} | {note} |")
    print()

    print("### Multi-pod deltas (512 chips; collective term change)\n")
    print("| arch | shape | t_coll single | t_coll multi | ratio |")
    print("|---|---|---|---|---|")
    for a in archs:
        for s in shapes:
            r1 = rows.get((a, s, "single"))
            r2 = rows.get((a, s, "multi"))
            if not r1 or not r2 or "skipped" in r1 or "error" in r1 or \
               "skipped" in r2 or "error" in r2:
                continue
            t1, t2 = r1["t_collective_s"], r2["t_collective_s"]
            print(f"| {a} | {s} | {fmt_t(t1)} | {fmt_t(t2)} | "
                  f"{t2/max(t1,1e-12):.2f}x |")


def _note(r):
    b = r["bottleneck"]
    kinds = r.get("collective_by_kind", {})
    if b == "collective" and kinds:
        top = max(kinds, key=kinds.get)
        return f"dominant: {top} ({kinds[top]/2**30:.0f} GiB/dev)"
    if b == "compute":
        return "MXU-bound; raise MODEL/HLO via causal-aware attention"
    return "HBM-bound; params/cache streaming"


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "results/final/dryrun.jsonl")

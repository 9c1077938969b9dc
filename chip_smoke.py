#!/usr/bin/env python3
"""Run the PyTorch + CUDA port's auction round on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. the card's name and power limit, and the build of every hand-written
   kernel (``src/repro_torch/kernels/csrc/*.cu``, one nvcc per source, in
   parallel) with its ptxas report;
2. each kernel against its plain torch version on the card, on seeded
   inputs at the main path's shapes: the Eq. 4 score + FMP safety kernel
   (K1) at M = 32768, T = 32, and the batched WIS settle kernel (K2) at
   W = 64 windows, L = 2048 lanes plus one L whose row needs more than 48 KB
   of shared memory and one past the shared-memory limit (global scratch),
   fused with and without a transform.  Scores and totals must be bit-equal,
   eligibility and selections exactly equal.  Each kernel is timed with CUDA
   events beside its plain version and its bound;
3. the main path: ``simulate`` of a 16-GPU H100 cluster cut into 64 MIG
   slices (3g.40gb + 2g.20gb + 1g.10gb + 1g.10gb per GPU) against a
   backlog of 500 jobs, through the CUDA kernels pipelined and serial and
   through the plain torch versions on the card.  Launch counters are reset
   just before the pipelined run and read just after; commit logs and
   summaries must be identical across the three runs, no backend may be
   marked failed, and a small seeded run on the card must match the same
   run on the host.

The line before the last is a JSON object with every kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA card; runs
nothing on the host in its place.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth and
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

GB = 1 << 30
MIG_PROFILES = (("3g.40gb", 40, 3), ("2g.20gb", 20, 2),
                ("1g.10gb-a", 10, 1), ("1g.10gb-b", 10, 1))


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, *, reps: int, inner: int) -> float:
    """Median per-call device time (ms) of ``fn`` from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def ulp_gap(torch, a, b) -> int:
    """Largest distance in float32 units in the last place between a and b."""
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    # map the sign-magnitude bit patterns onto one ordered integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max().item()) if a.numel() else 0


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def score_inputs(np, torch, dev, m: int, t: int):
    """Round-path operands: ĥ column (Fj = 1, α = [1]), Fs = 4, T grid points,
    heterogeneous caps/θ, ~10% σ = 0 points, and a final pad-row block."""
    rng = np.random.default_rng(SEED)
    fj = rng.uniform(0, 1, (m, 1)).astype(np.float32)
    fs = rng.uniform(0, 1, (m, 4)).astype(np.float32)
    al = np.array([1.0], np.float32)
    be = np.array([0.4, 0.2, 0.1, 0.2], np.float32)
    cap = rng.uniform(15.0, 25.0, m).astype(np.float32)
    # per-row risk: most rows sit well under their cap, some brush it (the
    # σ = 0 points of those are deterministic violations)
    risk = rng.uniform(0.6, 1.03, (m, 1))
    mu = (cap[:, None] * risk * rng.uniform(0.7, 1.0, (m, t))).astype(np.float32)
    sg = (cap[:, None] * rng.uniform(0.0, 0.06, (m, t))).astype(np.float32)
    sg[rng.uniform(size=(m, t)) < 0.1] = 0.0
    lam = rng.uniform(0.2, 0.8, m).astype(np.float32)
    theta = rng.uniform(0.01, 0.3, m).astype(np.float32)
    pad = slice(m - 256, m)  # bucket padding as ops.score_variants writes it
    fj[pad] = 0.0
    fs[pad] = 0.0
    mu[pad] = 1.0
    sg[pad] = 0.0
    lam[pad] = cap[pad] = theta[pad] = 0.0
    arrays = (fj, fs, al, be, mu, sg, lam, cap, theta)
    return [torch.from_numpy(a).to(dev) for a in arrays]


def check_score_kernel(np, torch, dev, k1, ref):
    m, t = 32768, 32
    args = score_inputs(np, torch, dev, m, t)
    score, elig = k1.score_variants_cuda(*args)
    p_score, p_elig, _ = ref.score_variants_reference(
        *args[:6], lam=args[6], capacity=args[7], theta=args[8])
    torch.cuda.synchronize()
    if not torch.equal(elig, p_elig):
        raise AssertionError(
            f"K1 eligibility differs on {int((elig != p_elig).sum())} rows")
    gap = ulp_gap(torch, score, p_score)
    err = float((score - p_score).abs().max().item())
    if gap != 0:
        raise AssertionError(f"K1 scores differ by {gap} ulps (max abs {err})")
    if elig[m - 256:].any() or score[m - 256:].any():
        raise AssertionError("K1 pad rows are not self-masking")
    n_elig = int(elig.sum().item())
    if not (0 < n_elig < m - 256):
        raise AssertionError(f"K1 safety check did no work ({n_elig} eligible)")
    if not torch.isfinite(score).all():
        raise AssertionError("K1 produced non-finite scores")

    lib = k1._lib()
    out_s = torch.empty_like(score)
    out_e = torch.empty_like(elig)
    ptrs = [a.data_ptr() for a in args]
    stream = torch.cuda.current_stream().cuda_stream

    def raw():  # the kernel alone: no validation or allocation per call
        lib.jasda_score_launch(*ptrs, m, 1, 4, t, out_s.data_ptr(),
                               out_e.data_ptr(), stream)

    ms = time_ms(torch, raw, reps=21, inner=50)
    plain_ms = time_ms(torch, lambda: ref.score_variants_reference(
        *args[:6], lam=args[6], capacity=args[7], theta=args[8]),
        reps=5, inner=3)
    n_bytes = (m * (1 + 4 + 2 * t + 3) * 4 + (1 + 4) * 4) + m * 4 + m
    # one operation per elementwise op or transcendental call: the dots and
    # score (2 (Fj + Fs) + 4), per grid point z, its branch and log Φ (~8),
    # and the final expm1 + compare
    n_ops = m * (2 * (1 + 4) + 4 + 8 * t + 2)
    bound_s = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
    log(f"K1 jasda_score M={m} T={t}: eligible {n_elig}/{m - 256}, scores "
        f"bit-equal (0 ulps), kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_s * 1e3:.4f} ms ({n_bytes} bytes)")
    return score, {
        "max_abs_err": err, "ulps": gap, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / F32_OPS_PER_S
        else "operations",
        "shape": {"M": m, "Fj": 1, "Fs": 4, "T": t},
    }


def settle_inputs(np, torch, dev, n_rows: int, lanes: int, m_pad: int, seed: int):
    """(W, L) sorted lanes over a pool of m_pad rows: idx (−1 on ~20% pads),
    predecessors from the host's float64 stable sort, a transform."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m_pad, (n_rows, lanes)).astype(np.int32)
    idx[rng.random((n_rows, lanes)) < 0.2] = -1
    starts = rng.integers(0, 4 * lanes, (n_rows, lanes)) / 2.0
    ends = starts + rng.integers(1, 64, (n_rows, lanes)) / 2.0
    order = np.argsort(ends, axis=1, kind="stable")
    e_s = np.take_along_axis(ends, order, axis=1)
    s_s = np.take_along_axis(starts, order, axis=1)
    pred = np.stack([np.searchsorted(e_s[k], s_s[k], side="right")
                     for k in range(n_rows)]).astype(np.int32)
    transform = (1.0 + rng.random(m_pad) * 0.5).astype(np.float32)
    t = {"idx": idx, "mask": idx >= 0, "pred": pred, "transform": transform}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in t.items()}


def check_settle_kernel(np, torch, dev, k2, ref, scores):
    m_pad = int(scores.shape[0])
    cases = [  # (W, L, form)
        (64, 2048, "fused"), (64, 2048, "fused+transform"),
        (64, 2048, "batched"), (64, 16384, "fused+transform"),
        (64, 32768, "fused"),
    ]
    branches = set()
    main = None
    for n, (n_rows, lanes, form) in enumerate(cases):
        t = settle_inputs(np, torch, dev, n_rows, lanes, m_pad, SEED + 1 + n)
        tr = t["transform"] if form == "fused+transform" else None
        w = ref.fused_weights(scores, t["idx"], t["mask"], tr)
        if form == "batched":
            sel, tot = k2.wis_batch_cuda(t["pred"], weights=w)
        else:
            sel, tot = k2.wis_batch_cuda(t["pred"], scores=scores, idx=t["idx"],
                                         mask=t["mask"], transform=tr)
        p_sel, p_tot = ref.wis_batch_reference(w, t["pred"])
        torch.cuda.synchronize()
        if not torch.equal(sel, p_sel):
            raise AssertionError(f"K2 {form} L={lanes}: selections differ")
        if ulp_gap(torch, tot, p_tot) != 0:
            raise AssertionError(f"K2 {form} L={lanes}: totals not bit-equal")
        if not int(sel.sum().item()) or not torch.isfinite(tot).all():
            raise AssertionError(f"K2 {form} L={lanes}: empty or non-finite")
        row = k2.row_bytes(lanes)
        branch = ("global scratch" if not k2.uses_shared_memory(lanes, dev)
                  else "shared > 48 KB" if row > 48 * 1024 else "shared")
        branches.add(branch)
        log(f"K2 wis_batch W={n_rows} L={lanes} {form}: selections and totals "
            f"equal, row {row} bytes in {branch}")
        if (lanes, form) == (2048, "fused"):
            main = (t, n_rows, lanes)
    if branches != {"shared", "shared > 48 KB", "global scratch"}:
        raise AssertionError(f"K2 branches exercised: {sorted(branches)}")

    t, n_rows, lanes = main
    lib = k2._lib()
    sel = torch.empty((n_rows, lanes), dtype=torch.bool, device=dev)
    tot = torch.empty((n_rows,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        lib.wis_batch_launch(None, scores.data_ptr(), None,
                             t["idx"].data_ptr(), t["mask"].data_ptr(),
                             t["pred"].data_ptr(), n_rows, lanes, m_pad,
                             sel.data_ptr(), tot.data_ptr(), None, stream)

    ms = time_ms(torch, raw, reps=11, inner=10)
    plain_ms = time_ms(torch, lambda: ref.wis_batch_reference(
        ref.fused_weights(scores, t["idx"], t["mask"]), t["pred"]),
        reps=3, inner=1)
    lanes_total = n_rows * lanes
    # idx + mask + pred read once, the score vector read once, sel + totals
    n_bytes = lanes_total * (4 + 1 + 4) + m_pad * 4 + lanes_total + n_rows * 4
    n_ops = lanes_total * 3  # gather-mask select, add, compare per lane
    bound_s = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
    log(f"K2 wis_batch W={n_rows} L={lanes} fused: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.2f} ms, bound {bound_s * 1e3:.5f} ms ({n_bytes} bytes)")
    return {
        "max_abs_err": 0.0, "ulps": 0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / F32_OPS_PER_S
        else "operations",
        "shape": {"W": n_rows, "L": lanes, "M_pad": m_pad},
    }


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------


def cluster(SliceSpec):
    return [SliceSpec(f"gpu{g:02d}-{name}", cap * GB, n_chips=units)
            for g in range(16) for name, cap, units in MIG_PROFILES]


def run_sim(core, impl, *, pipeline, device, workload, sim):
    from repro_torch.core.scheduler import SchedulerConfig

    cfg = SchedulerConfig.from_policy(
        core.Policy(per_agent_theta=True), score_impl=impl, wis_impl=impl,
        device=device)
    sched = core.JasdaScheduler(workload["slices"](core.SliceSpec), cfg)
    t0 = time.perf_counter()
    res = core.simulate(sched, core.make_workload(**workload["jobs"]),
                        core.SimConfig(pipeline=pipeline, **sim))
    wall = time.perf_counter() - t0
    commits = [(c.variant_id, c.slice_id, c.t_start, c.score)
               for c in sched.commit_log]
    rounds = [r for r in sched.log if r.n_windows]
    failed = sched.backend_health.failed_backends()
    if failed:
        raise AssertionError(f"{impl} run marked backends failed: {failed}")
    return {"commits": commits, "summary": res.summary(), "wall_s": wall,
            "rounds": len(rounds),
            "max_bids": max((r.n_bids for r in rounds), default=0),
            "max_windows": max((r.n_windows for r in rounds), default=0)}


def main_path(torch, dev, k1, k2):
    import repro_torch.core as core
    from repro_torch.kernels.jasda_score.ops import bucket_m

    workload = {"slices": cluster,
                "jobs": dict(n_jobs=500, seed=0, arrival_rate=100.0,
                             mem_range_gb=(2.0, 36.0))}
    sim = dict(t_end=20.0, seed=1)
    k1.LAUNCHES["jasda_score"] = 0
    k2.LAUNCHES["wis_batch"] = 0
    k1.SHAPES.clear()
    k2.SHAPES.clear()
    cuda_pipe = run_sim(core, "cuda", pipeline=True, device=dev,
                        workload=workload, sim=sim)
    launches = {"jasda_score": k1.LAUNCHES["jasda_score"],
                "wis_batch": k2.LAUNCHES["wis_batch"]}
    shapes = {"jasda_score": dict(k1.SHAPES), "wis_batch": dict(k2.SHAPES)}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never ran: {launches}")
    log(f"main path cuda pipelined: {cuda_pipe['rounds']} rounds, max "
        f"{cuda_pipe['max_bids']} bids/round (M bucket "
        f"{bucket_m(cuda_pipe['max_bids'])}), max {cuda_pipe['max_windows']} "
        f"windows, launches {launches}, {cuda_pipe['wall_s']:.2f} s wall")
    log(f"  K1 shapes (M, Fj, Fs, T): {shapes['jasda_score']}")
    log(f"  K2 shapes (W, L, fused, transformed): {shapes['wis_batch']}")
    log(f"  {cuda_pipe['summary']}")

    k1.LAUNCHES["jasda_score"] = 0
    k2.LAUNCHES["wis_batch"] = 0
    cuda_serial = run_sim(core, "cuda", pipeline=False, device=dev,
                          workload=workload, sim=sim)
    serial_launches = {"jasda_score": k1.LAUNCHES["jasda_score"],
                       "wis_batch": k2.LAUNCHES["wis_batch"]}
    if not all(serial_launches.values()):
        raise AssertionError(f"serial run skipped a kernel: {serial_launches}")
    log(f"main path cuda serial: launches {serial_launches}, "
        f"{cuda_serial['wall_s']:.2f} s wall")

    k1.LAUNCHES["jasda_score"] = 0
    k2.LAUNCHES["wis_batch"] = 0
    torch_run = run_sim(core, "torch", pipeline=True, device=dev,
                        workload=workload, sim=sim)
    if k1.LAUNCHES["jasda_score"] or k2.LAUNCHES["wis_batch"]:
        raise AssertionError("the plain torch run launched a CUDA kernel")
    log(f"main path torch on the card: {torch_run['wall_s']:.2f} s wall")

    for name, other in (("cuda serial", cuda_serial), ("torch", torch_run)):
        if other["commits"] != cuda_pipe["commits"]:
            raise AssertionError(f"{name} commit log differs from cuda pipelined")
        if other["summary"] != cuda_pipe["summary"]:
            raise AssertionError(f"{name} summary differs: {other['summary']}")
    if not cuda_pipe["commits"]:
        raise AssertionError("the main path committed nothing")
    log(f"commit logs ({len(cuda_pipe['commits'])} rows) and summaries "
        "identical across cuda pipelined, cuda serial and torch on the card")

    host = run_sim(core, "numpy", pipeline=False, device="cpu",
                   workload=workload, sim=sim)
    log(f"host float64 reference summary {'matches' if host['summary'] == cuda_pipe['summary'] else 'differs'}"
        f": {host['summary']} ({host['wall_s']:.2f} s wall)")

    # a small seeded run: the kernels on the card against the plain
    # versions on the host, commit for commit
    small = {"slices": lambda S: [S("s20", 20 * GB, n_chips=4),
                                  S("s10", 10 * GB, n_chips=2),
                                  S("s5", 5 * GB, n_chips=1)],
             "jobs": dict(n_jobs=40, seed=3, arrival_rate=0.3)}
    small_sim = dict(t_end=900.0, seed=2)
    on_card = run_sim(core, "cuda", pipeline=True, device=dev,
                      workload=small, sim=small_sim)
    on_host = run_sim(core, "torch", pipeline=True, device="cpu",
                      workload=small, sim=small_sim)
    if ([c[:3] for c in on_card["commits"]] != [c[:3] for c in on_host["commits"]]
            or on_card["summary"] != on_host["summary"]):
        raise AssertionError("small run: card and host disagree")
    worst = max((abs(a[3] - b[3]) for a, b in zip(on_card["commits"],
                                                    on_host["commits"])),
                default=0.0)
    if worst > 3e-5:
        raise AssertionError(f"small run: scores differ by {worst}")
    log(f"small run: {len(on_card['commits'])} commits identical on card and "
        f"host (max score gap {worst})")
    device_share(torch, core, dev, workload, sim)
    return launches, cuda_pipe


def device_share(torch, core, dev, workload, sim) -> None:
    """Where the main path's time goes: the cuda serial run once more under
    torch.profiler, its device time by kind over its (profiled) wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = run_sim(core, "cuda", pipeline=False, device=dev,
                      workload=workload, sim=sim)
        torch.cuda.synchronize()
    groups = {"score_kernel": 0.0, "wis_batch_kernel": 0.0, "memcpy": 0.0,
              "other": 0.0}
    for e in prof.key_averages():
        # device activities only: a CPU op's self device time repeats the
        # time of the kernels and copies it launched
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        key = next((g for g in groups if g in e.key or
                    (g == "memcpy" and "Memcpy" in e.key)), "other")
        groups[key] += us / 1e6
    busy = sum(groups.values())
    if busy == 0.0:
        log("device share: not measured (the profiler saw no device time)")
        return
    log(f"device share, cuda serial under torch.profiler: {run['wall_s']:.3f} s "
        f"wall, device busy {busy:.4f} s ({100 * busy / run['wall_s']:.3f}%), "
        + ", ".join(f"{k} {v:.4f} s" for k, v in groups.items()))


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        return fail(f"the port's package is missing under {src}")
    sys.path.insert(0, str(src))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch sees no CUDA device")
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from repro_torch.kernels import common
    from repro_torch.kernels.jasda_score import kernel as k1
    from repro_torch.kernels.jasda_score import ref as k1_ref
    from repro_torch.kernels.wis_dp import kernel as k2
    from repro_torch.kernels.wis_dp import ref as k2_ref

    t0 = time.perf_counter()
    reports = common.build_all()
    log(f"built {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    scores, k1_row = check_score_kernel(np, torch, dev, k1, k1_ref)
    k2_row = check_settle_kernel(np, torch, dev, k2, k2_ref, scores)
    launches, run = main_path(torch, dev, k1, k2)

    kernels = [
        dict(name="jasda_score", route="cuda",
             source="src/repro_torch/kernels/csrc/jasda_score.cu",
             replaces="src/repro/kernels/jasda_score/kernel.py:87",
             launches=launches["jasda_score"], library_ms=None, **k1_row),
        dict(name="wis_batch", route="cuda",
             source="src/repro_torch/kernels/csrc/wis_batch.cu",
             replaces="src/repro/kernels/wis_dp/kernel.py:111",
             launches=launches["wis_batch"], library_ms=None, **k2_row),
    ]
    for k in kernels:
        k["launches_per_round"] = k["launches"] / max(run["rounds"], 1)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # report the failing phase, print no result
        import traceback

        traceback.print_exc()
        sys.exit(fail(f"{type(exc).__name__}: {exc}"))

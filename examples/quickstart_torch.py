"""Quickstart on the PyTorch port: the JASDA interaction cycle end to end.

The same cycle as ``examples/quickstart.py``, through ``repro_torch``.
``--device`` is where every round is scored and cleared: on the CUDA card
(the default) through the CUDA kernels, or with ``--device cpu`` through
their plain torch versions on the host.  Both give the same schedule.

1. Build a MIG-like slice pool.
2. Submit a mixed workload of jobs (each with an FMP memory profile).
3. Run the scheduler loop in simulation; print the audit trail + metrics.
4. Run the SAME schedule under FIFO for contrast.

Run: PYTHONPATH=src python examples/quickstart_torch.py [--steps N] [--device cpu]
"""
import argparse

from repro_torch.core import (JasdaScheduler, SimConfig, SliceSpec,
                              make_workload, simulate)
from repro_torch.core.baselines import FifoScheduler
from repro_torch.core.scheduler import SchedulerConfig

GB = 1 << 30


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40, help="number of jobs")
    ap.add_argument("--device", default="cuda",
                    help="where rounds are scored and cleared (default: the card)")
    args = ap.parse_args()
    impl = "cuda" if args.device.startswith("cuda") else "torch"

    # a heterogeneous MIG-style pool: 1×20GB, 2×10GB, 4×5GB slices
    slices = [SliceSpec("s20", 20 * GB, n_chips=4),
              SliceSpec("s10a", 10 * GB, n_chips=2),
              SliceSpec("s10b", 10 * GB, n_chips=2)] + \
             [SliceSpec(f"s5{i}", 5 * GB, n_chips=1) for i in range(4)]

    print("=== JASDA (bid → clear → commit → verify) ===")
    sched = JasdaScheduler(slices, SchedulerConfig(
        device=args.device, score_impl=impl, wis_impl=impl))
    agents = make_workload(args.steps, seed=7, arrival_rate=0.3,
                           mem_range_gb=(1.0, 14.0))
    res = simulate(sched, agents, SimConfig(t_end=4000.0, seed=1))
    print("JASDA :", res.summary())

    # a few audit-trail rows (transparency, paper §5(f))
    rows = [r for r in sched.log if r.n_selected > 0][:5]
    print("\nfirst five clearing iterations:")
    for r in rows:
        print(f"  t={r.t:7.1f} window={r.window.slice_id:５}"
              f" bids={r.n_bids:2d} selected={r.n_selected} "
              f"total_score={r.total_score:.2f}")

    print("\nper-job reliability (ex-post verification, §4.2.1):")
    snap = sched.calibrator.snapshot()
    some = list(snap.items())[:5]
    for job, s in some:
        print(f"  {job}: rho={s['rho']:.3f} verified={s['n_verified']}")

    print("\n=== FIFO baseline (whole jobs, head-of-line) ===")
    agents = make_workload(args.steps, seed=7, arrival_rate=0.3,
                           mem_range_gb=(1.0, 14.0))
    res_f = simulate(FifoScheduler(slices), agents, SimConfig(t_end=4000.0, seed=1))
    print("FIFO  :", res_f.summary())


if __name__ == "__main__":
    main()

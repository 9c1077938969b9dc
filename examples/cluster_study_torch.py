"""Cluster-scale scheduling study on the PyTorch port: JASDA vs baselines
with failures, stragglers and elastic capacity, the policy presets, and the
mixed-strategy bidder population.

The same study as ``examples/cluster_study.py``, through ``repro_torch``.
``--device`` is where JASDA's rounds are scored and cleared: on the CUDA
card (the default) through the scoring and batched-settle kernels, or with
``--device cpu`` through their plain torch versions on the host.  The
study's 7-slice pool never holds the 256 bids above which the scheduler
moves a round to the device by itself, so every JASDA scheduler here asks
for the device backends; each round's pool is padded to 256 bid rows and 8
window rows, one scoring launch a round and at least one settle launch.
The FIFO, EASY-backfill, best-fit and auction baselines run on the host.

Run: PYTHONPATH=src python examples/cluster_study_torch.py [--device cpu]
"""
import argparse

from repro_torch.core import (AdaptiveBidder, ConservativeSafety,
                              GreedyChunking, JasdaScheduler, Policy,
                              SimConfig, SliceSpec, make_workload, simulate)
from repro_torch.core.baselines import (AuctionScheduler, BackfillScheduler,
                                        BestFitScheduler, FifoScheduler)
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.windows import WindowPolicy
from repro_torch.kernels.common import resolve_device

GB = 1 << 30


def pool():
    return ([SliceSpec("s20", 20 * GB, n_chips=4),
             SliceSpec("s10a", 10 * GB, n_chips=2),
             SliceSpec("s10b", 10 * GB, n_chips=2)]
            + [SliceSpec(f"s5{i}", 5 * GB, n_chips=1) for i in range(4)])


def workload():
    return make_workload(240, seed=1, arrival_rate=0.25,
                         work_range=(20.0, 150.0), mem_range_gb=(1.0, 14.0))


def jasda(policy, device, impl):
    """JASDA on ``pool()`` under ``policy``, its rounds scored and cleared
    by backend ``impl`` ("cuda" | "torch"; None: the scheduler's own
    choice, host numpy and the per-window host loop at this pool's size)
    on ``device``."""
    return JasdaScheduler(pool(), SchedulerConfig.from_policy(
        policy, device=device, score_impl=impl, wis_impl=impl))


SYSTEMS = [("JASDA", lambda device, impl: jasda(Policy(), device, impl)),
           ("FIFO", lambda device, impl: FifoScheduler(pool())),
           ("EASY-backfill", lambda device, impl: BackfillScheduler(pool())),
           ("best-fit", lambda device, impl: BestFitScheduler(pool())),
           ("auction", lambda device, impl: AuctionScheduler(pool()))]


def run(title, *, device="cuda", impl="cuda", **sim_kw):
    print(f"\n=== {title} ===")
    print(f"{'system':14s} {'util':>6s} {'meanJCT':>8s} {'p95':>8s} "
          f"{'jain':>6s} {'done':>8s}")
    for name, mk in SYSTEMS:
        res = simulate(mk(device, impl), workload(), SimConfig(seed=2, **sim_kw))
        print(f"{name:14s} {res.utilization:6.3f} {res.mean_jct:8.0f} "
              f"{res.p95_jct:8.0f} {res.jain_slowdown:6.3f} "
              f"{res.n_finished:4d}/{res.n_jobs}")


PRESETS = [("balanced", Policy),
           ("utilization", Policy.utilization),
           ("fairness", Policy.fairness),
           ("responsive", Policy.responsive)]


def run_presets(*, device="cuda", impl="cuda", **sim_kw):
    """Sweep the unified policy presets on the same workload/slices."""
    print("\n=== JASDA policy presets (same workload, swapped Policy) ===")
    print(f"{'preset':14s} {'clearing':18s} {'util':>6s} {'meanJCT':>8s} "
          f"{'p95':>8s} {'jain':>6s} {'done':>8s}")
    for name, mk in PRESETS:
        policy = mk()
        res = simulate(jasda(policy, device, impl), workload(),
                       SimConfig(seed=2, **sim_kw))
        print(f"{name:14s} {policy.clearing.name:18s} {res.utilization:6.3f} "
              f"{res.mean_jct:8.0f} {res.p95_jct:8.0f} "
              f"{res.jain_slowdown:6.3f} {res.n_finished:4d}/{res.n_jobs}")


def run_strategies(*, device="cuda", impl="cuda", **sim_kw):
    """Mixed-strategy population: the bid-side negotiation matchup.

    One run, one scheduler — jobs differ ONLY in their BiddingStrategy
    (assigned round-robin by make_workload).  A short announcement horizon
    keeps windows contested, so the feedback loop (cutoffs, loss reasons,
    calibration bias) has something to adapt to.
    """
    print("\n=== mixed bidding strategies (same jobs, swapped strategy) ===")
    strategies = [GreedyChunking(), AdaptiveBidder(), ConservativeSafety()]
    sched = jasda(Policy(window=WindowPolicy(horizon=60.0)), device, impl)
    agents = make_workload(240, seed=1, arrival_rate=0.25,
                           work_range=(20.0, 150.0), mem_range_gb=(1.0, 14.0),
                           misreport_fraction=0.3, misreport_factor=1.5,
                           strategies=strategies)
    res = simulate(sched, agents, SimConfig(seed=2, **sim_kw))
    print(f"{'strategy':20s} {'jobs':>5s} {'done':>5s} {'bids':>6s} "
          f"{'wins':>6s} {'win%':>6s} {'cleared':>9s}")
    for name, row in sorted(res.strategy_stats.items()):
        wr = row["n_wins"] / max(row["n_bids"], 1)
        print(f"{name:20s} {row['n_jobs']:5d} {row['n_finished']:5d} "
              f"{row['n_bids']:6d} {row['n_wins']:6d} {wr:6.2f} "
              f"{row['score_won']:9.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where JASDA's rounds are scored and cleared "
                         "(default: the card)")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    dev = dict(device=device,
               impl="cuda" if device.startswith("cuda") else "torch")
    run("steady state (heterogeneous MIG pool)", t_end=6000.0, **dev)
    run("with slice failures (MTBF ~5.5 min, repair 50 s)",
        t_end=9000.0, failure_rate=0.003, **dev)
    run_presets(t_end=6000.0, **dev)
    run_strategies(t_end=6000.0, **dev)
    print("\nNote: monolithic baselines lose the WHOLE job on a failure; "
          "JASDA loses one chunk (atomization = checkpoint boundaries). "
          "Preset rows swap ONE Policy object: scoring weights, window "
          "ordering, age curve and the clearing backend move together; "
          "strategy rows swap ONE AgentConfig.strategy per job and read "
          "per-strategy outcomes off SimResult.strategy_stats.")


if __name__ == "__main__":
    main()

"""Soak launcher for the streaming auction service (repro_torch.service).

The port's counterpart of ``repro/launch/serve_auction.py``, with the same
flags plus ``--device`` (``cuda`` unless ``cpu`` is asked for), the device
of the scheduler's scoring and settle backends.  Runs a long-lived
:class:`JasdaService` on the standard heterogeneous 7-slice cluster under a chosen open-loop arrival process and admission
policy, and reports the final :class:`ServiceStats` (SLO quantiles,
goodput, shed counts).  Deterministic per ``--seed``: two identical
invocations print identical stats.

CPU/dev:
    PYTHONPATH=src python -m repro_torch.launch.serve_auction --device cpu \
        --arrivals poisson --rate 0.5 --t-end 240 --admission bounded --json
Crash-resume demo (run, then rerun with --resume to continue from the
newest checkpoint):
    python -m repro_torch.launch.serve_auction --checkpoint-dir svc_ckpt
    python -m repro_torch.launch.serve_auction --checkpoint-dir svc_ckpt \
        --resume
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from ..checkpoint import CheckpointError, CheckpointStore
from ..core import JasdaScheduler, SliceSpec
from ..core.scheduler import SchedulerConfig
from ..service import (AcceptAll, BoundedQueue, BurstArrivals,
                       DiurnalArrivals, JasdaService, PoissonArrivals,
                       ServiceConfig, TokenBucket)

_GB = 1 << 30


def _cluster():
    """The benchmarks' heterogeneous 7-slice cluster (~12 chips)."""
    return ([SliceSpec("s20", 20 * _GB, n_chips=4),
             SliceSpec("s10a", 10 * _GB, n_chips=2),
             SliceSpec("s10b", 10 * _GB, n_chips=2)]
            + [SliceSpec(f"s5{i}", 5 * _GB, n_chips=1) for i in range(4)])


def _arrivals(args):
    kw = dict(seed=args.seed, work_range=(args.work_min, args.work_max),
              qos_fraction=args.qos_fraction,
              deadline_slack=(args.slack_min, args.slack_max),
              cancel_fraction=args.cancel_fraction)
    if args.arrivals == "poisson":
        return PoissonArrivals(args.rate, **kw)
    if args.arrivals == "burst":
        return BurstArrivals(args.rate, args.burst_rate, **kw)
    if args.arrivals == "diurnal":
        return DiurnalArrivals(args.rate, period=args.period, **kw)
    raise SystemExit(f"unknown arrival process: {args.arrivals}")


def _admission(args):
    if args.admission == "accept-all":
        return AcceptAll()
    if args.admission == "bounded":
        return BoundedQueue(args.max_queue)  # None → engine resolves
    if args.admission == "token-bucket":
        return TokenBucket(args.token_rate, burst=args.token_burst)
    raise SystemExit(f"unknown admission policy: {args.admission}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arrivals", default="poisson",
                    choices=("poisson", "burst", "diurnal"))
    ap.add_argument("--rate", type=float, default=0.5,
                    help="arrival rate (poisson/burst quiet/diurnal peak)")
    ap.add_argument("--burst-rate", type=float, default=1.5,
                    help="MMPP burst-state rate (--arrivals burst)")
    ap.add_argument("--period", type=float, default=500.0,
                    help="diurnal period (--arrivals diurnal)")
    ap.add_argument("--work-min", type=float, default=8.0)
    ap.add_argument("--work-max", type=float, default=40.0)
    ap.add_argument("--qos-fraction", type=float, default=0.3)
    ap.add_argument("--slack-min", type=float, default=2.0)
    ap.add_argument("--slack-max", type=float, default=6.0)
    ap.add_argument("--cancel-fraction", type=float, default=0.0)
    ap.add_argument("--admission", default="accept-all",
                    choices=("accept-all", "bounded", "token-bucket"))
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded-queue pool cap (default: from bucket)")
    ap.add_argument("--token-rate", type=float, default=0.5)
    ap.add_argument("--token-burst", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the scheduler's backends (cuda or cpu)")
    ap.add_argument("--t-end", type=float, default=240.0)
    ap.add_argument("--round-dt", type=float, default=1.0)
    ap.add_argument("--max-bucket-m", type=int, default=512)
    ap.add_argument("--no-pipeline", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="periodically snapshot full service state here")
    ap.add_argument("--checkpoint-every", type=int, default=50,
                    help="rounds between snapshots (--checkpoint-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="restore from --checkpoint-dir and continue")
    ap.add_argument("--json", action="store_true",
                    help="emit the final ServiceStats as one JSON line")
    args = ap.parse_args(argv)

    store = None
    if args.checkpoint_dir is not None:
        store = CheckpointStore(args.checkpoint_dir, keep=3)

    if args.resume:
        if store is None:
            raise SystemExit("--resume requires --checkpoint-dir")
        try:
            svc = JasdaService.restore(store)
        except FileNotFoundError:
            raise SystemExit(
                f"no checkpoint to resume in {args.checkpoint_dir}")
        except CheckpointError as e:
            raise SystemExit(f"checkpoint unreadable: {e}")
    else:
        cfg = ServiceConfig(
            round_dt=args.round_dt, t_end=args.t_end, seed=args.seed,
            pipeline=not args.no_pipeline, max_bucket_m=args.max_bucket_m)
        svc = JasdaService(JasdaScheduler(
                               _cluster(), SchedulerConfig(device=args.device)),
                           _arrivals(args),
                           config=cfg, admission=_admission(args))

    stats = svc.run(args.t_end, checkpoint=store,
                    checkpoint_every=args.checkpoint_every)
    if args.json:
        print(json.dumps(dataclasses.asdict(stats)))
    else:
        print(stats.summary())
        print(f"  announce->award p50={stats.announce_award_p50:.2f} "
              f"p95={stats.announce_award_p95:.2f} "
              f"p99={stats.announce_award_p99:.2f}")
        print(f"  revoked={stats.n_revoked_slices} "
              f"degraded={stats.n_degraded_slices} "
              f"expired={stats.n_expired} cancelled={stats.n_cancelled}")
    if stats.n_rounds == 0:
        print("error: service ran zero rounds (horizon before first tick?)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

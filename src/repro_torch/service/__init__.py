"""Streaming service mode: a long-lived JASDA auction under open-loop load.

See :mod:`repro_torch.service.engine` for the loop, :mod:`repro_torch.service.arrivals`
for the seeded traffic models, :mod:`repro_torch.service.admission` for
back-pressure, and :mod:`repro_torch.service.metrics` for the streaming SLO
quantiles.
"""
from .admission import (AcceptAll, AdmissionPolicy, BoundedQueue, TokenBucket,
                        queue_bound_for_bucket)
from .arrivals import (ArrivalProcess, BurstArrivals, DeadlineExpired,
                       DiurnalArrivals, JobArrival, JobCancel, PoissonArrivals)
from .engine import AwardRecord, JasdaService, ServiceConfig
from .metrics import JobTimeline, P2Quantile, ServiceMetrics, ServiceStats

__all__ = [
    "AcceptAll",
    "AdmissionPolicy",
    "ArrivalProcess",
    "AwardRecord",
    "BoundedQueue",
    "BurstArrivals",
    "DeadlineExpired",
    "DiurnalArrivals",
    "JasdaService",
    "JobArrival",
    "JobCancel",
    "JobTimeline",
    "P2Quantile",
    "PoissonArrivals",
    "ServiceConfig",
    "ServiceMetrics",
    "ServiceStats",
    "TokenBucket",
    "queue_bound_for_bucket",
]

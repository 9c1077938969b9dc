"""Workload adapter: token-level serving requests through the auction.

The serving engine's docstring states the JASDA integration contract —
"a serving burst is a *job*".  This module closes the loop WITHOUT
touching either side: a :class:`~repro_torch.serving.engine.Request` maps to a
:class:`~repro_torch.core.types.JobSpec` whose work and memory footprint are
linear token models (prefill work per prompt token + decode work per new
token; KV-cache bytes per token on top of a base residency), and
:class:`ServingArrivals` replays a fixed ``(arrival_time, Request)``
trace through the :class:`~repro_torch.service.arrivals.ArrivalProcess`
machinery, so :class:`~repro_torch.service.engine.JasdaService` drives the
full admit → announce → award → complete timeline for every request.

The trace adapter draws NOTHING from the rng — job synthesis is a pure
function of the request — so two services replaying the same trace are
byte-identical regardless of seed, and the stream pickles mid-trace with
the rest of a service checkpoint (the cursor is an index).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..core.trp import fmp_standard
from ..core.types import JobSpec
from .engine import Request
from ..service.arrivals import ArrivalProcess, DeadlineExpired, JobArrival

__all__ = ["ServingArrivals", "request_job_spec"]

_GB = 1 << 30


def request_job_spec(
    req: Request,
    t: float,
    *,
    prefill_work_per_token: float = 0.1,
    decode_work_per_token: float = 0.5,
    kv_gb_per_token: float = 0.01,
    base_mem_gb: float = 2.0,
    deadline_factor: Optional[float] = None,
    prefix: str = "req-",
) -> JobSpec:
    """One serving request as an auction job (linear token cost model).

    Work = prefill·|prompt| + decode·max_new_tokens; steady memory =
    base + kv·(|prompt| + max_new_tokens).  ``deadline_factor`` (optional)
    sets a QoS deadline at ``t + factor × work`` — the serving-side SLO
    expressed in the auction's own deadline machinery.
    """
    n_prompt = int(len(req.prompt))
    n_new = int(req.max_new_tokens)
    work = prefill_work_per_token * n_prompt + decode_work_per_token * n_new
    steady = (base_mem_gb + kv_gb_per_token * (n_prompt + n_new)) * _GB
    fmp = fmp_standard(0.5 * steady, steady, 0.05 * steady, rel_sigma=0.02)
    deadline = t + deadline_factor * work if deadline_factor else None
    return JobSpec(
        job_id=f"{prefix}{req.request_id}",
        arrival_time=t,
        total_work=float(work),
        fmp=fmp,
        qos_deadline=deadline,
        metadata={
            "request_id": req.request_id,
            "prompt_tokens": n_prompt,
            "max_new_tokens": n_new,
        },
    )


class ServingArrivals(ArrivalProcess):
    """Replay a fixed serving trace as an open-loop arrival stream.

    ``requests`` is a sequence of ``(arrival_time, Request)``; events are
    emitted in ``(time, request_id)`` order through the inherited
    ``take_until`` cursor.  Deterministic: no rng draws.
    """

    name = "serving"

    def __init__(
        self,
        requests: Sequence[Tuple[float, Request]],
        *,
        prefill_work_per_token: float = 0.1,
        decode_work_per_token: float = 0.5,
        kv_gb_per_token: float = 0.01,
        base_mem_gb: float = 2.0,
        deadline_factor: Optional[float] = None,
        prefix: str = "req-",
        **kw,
    ):
        trace = sorted(requests, key=lambda r: (r[0], r[1].request_id))
        # a finite t_end is load-bearing: the base take_until loop only
        # exhausts when the next arrival EXCEEDS it
        kw.setdefault("t_end", trace[-1][0] if trace else 0.0)
        super().__init__(prefix=prefix, **kw)
        self.prefill_work_per_token = prefill_work_per_token
        self.decode_work_per_token = decode_work_per_token
        self.kv_gb_per_token = kv_gb_per_token
        self.base_mem_gb = base_mem_gb
        self.deadline_factor = deadline_factor
        self._trace = trace
        self._i = 0

    def _next_arrival(self, prev_t: float) -> float:
        if self._i >= len(self._trace):
            return self.t_end + 1.0  # exhausts the stream
        return max(prev_t, self._trace[self._i][0])

    def _draw_job(self, ta: float) -> None:
        _, req = self._trace[self._i]
        self._i += 1
        self._n += 1
        spec = request_job_spec(
            req, ta,
            prefill_work_per_token=self.prefill_work_per_token,
            decode_work_per_token=self.decode_work_per_token,
            kv_gb_per_token=self.kv_gb_per_token,
            base_mem_gb=self.base_mem_gb,
            deadline_factor=self.deadline_factor,
            prefix=self.prefix,
        )
        self._stage(ta, JobArrival(ta, spec))
        if spec.qos_deadline is not None:
            self._stage(spec.qos_deadline,
                        DeadlineExpired(spec.qos_deadline, spec.job_id))

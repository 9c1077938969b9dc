"""Scoring model (paper §4.2, Eqs. 1–4).

Each variant gets a normalized composite score

    Score(v) = λ · h̃(v) + (1 − λ) · f̃_sys(v),          λ ∈ [0, 1]   (Eq. 4)

with feature decompositions

    h̃(v)     = Σ_i α_i φ_i(v),   Σ_i α_i ≤ 1,  φ_i ∈ [0, 1]          (Eq. 2)
    f̃_sys(v) = Σ_j β_j ψ_j(v),   Σ_j β_j ≤ 1,  ψ_j ∈ [0, 1]          (Eq. 3)

so Score(v) ∈ [0, 1] by construction.  The paper's representative features
(φ_JCT, φ_QoS, ψ_energy, ψ_mem_headroom) are implemented below, plus the
system-side utilization/slack features its text describes and the age term of
§4.3 (β_age · A_i(t) folded into f̃_sys).

The scheduler-side evaluation is vectorized over the variant pool; the same
math is mirrored on the card by ``kernels/jasda_score``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np

from .types import Variant, Window

__all__ = [
    "ScoringPolicy",
    "JobFeatures",
    "SystemFeatures",
    "composite_score",
    "score_pool",
    "score_round",
    "score_round_async",
    "ScoreHandle",
    "job_utility",
    "system_utility",
    "POLICY_QOS_FIRST",
    "POLICY_BALANCED",
    "POLICY_UTILIZATION_FIRST",
]


# ---------------------------------------------------------------------------
# Policy (λ, α, β weights) — Table 2 presets
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScoringPolicy:
    """Policy weights governing the job/system trade-off (paper Table 2).

    ``alphas`` weight job-side features φ_i, ``betas`` weight system-side
    features ψ_j.  Weights must be non-negative with Σα ≤ 1, Σβ ≤ 1 so the
    composite score stays in [0, 1].
    """

    lam: float = 0.5  # λ
    alphas: Mapping[str, float] = field(
        default_factory=lambda: {"jct": 0.5, "qos": 0.3, "progress": 0.2}
    )
    betas: Mapping[str, float] = field(
        default_factory=lambda: {
            "utilization": 0.4,
            "slack": 0.2,
            "mem_headroom": 0.1,
            "energy": 0.1,
            "age": 0.2,
        }
    )

    def __post_init__(self):
        if not (0.0 <= self.lam <= 1.0):
            raise ValueError(f"lambda must be in [0,1], got {self.lam}")
        for name, w in list(self.alphas.items()) + list(self.betas.items()):
            if w < 0:
                raise ValueError(f"negative weight {name}={w}")
        if sum(self.alphas.values()) > 1.0 + 1e-9:
            raise ValueError("sum(alpha) must be <= 1")
        if sum(self.betas.values()) > 1.0 + 1e-9:
            raise ValueError("sum(beta) must be <= 1")

    @property
    def beta_age(self) -> float:
        return self.betas.get("age", 0.0)

    def replace(self, **kw) -> "ScoringPolicy":
        return dataclasses.replace(self, **kw)


# Pools smaller than this score on host numpy when impl is unset: one device
# launch costs more than the whole matmul at these sizes.
SMALL_POOL_M = 256

# Table 2 presets.
POLICY_QOS_FIRST = ScoringPolicy(lam=0.7)
POLICY_BALANCED = ScoringPolicy(lam=0.5)
POLICY_UTILIZATION_FIRST = ScoringPolicy(lam=0.3)


# ---------------------------------------------------------------------------
# Job-side features φ_i(v) ∈ [0,1]  (declared by the job)
# ---------------------------------------------------------------------------


class JobFeatures:
    """Reference implementations of the paper's job-side features.

    Jobs *declare* these (they may misreport — that is what §4.2.1 verifies);
    the functions here are what an honest job computes.
    """

    @staticmethod
    def jct(delta_jct: float, delta_jct_max: float) -> float:
        """φ_JCT = 1 − ΔJCT/ΔJCT_max : earlier expected completion → higher."""
        if delta_jct_max <= 0:
            return 1.0
        return float(np.clip(1.0 - delta_jct / delta_jct_max, 0.0, 1.0))

    @staticmethod
    def qos(meets_qos: bool) -> float:
        """φ_QoS = 1[meets QoS]."""
        return 1.0 if meets_qos else 0.0

    @staticmethod
    def progress(work_in_variant: float, work_remaining: float) -> float:
        """Fraction of the job's remaining work covered by this variant."""
        if work_remaining <= 0:
            return 1.0
        return float(np.clip(work_in_variant / work_remaining, 0.0, 1.0))


# ---------------------------------------------------------------------------
# System-side features ψ_j(v) ∈ [0,1]  (computed by the scheduler)
# ---------------------------------------------------------------------------


class SystemFeatures:
    @staticmethod
    def utilization(variant: Variant, window: Window) -> float:
        """ψ_util: fraction of the announced window the variant occupies."""
        if window.duration <= 0:
            return 0.0
        return float(np.clip(variant.duration / window.duration, 0.0, 1.0))

    @staticmethod
    def slack(variant: Variant, window: Window) -> float:
        """ψ_slack: 1 − normalized dead time the variant leaves *before* it.

        Variants that start right at the window start leave no leading gap
        (which could otherwise be unfillable), hence score 1.
        """
        if window.duration <= 0:
            return 1.0
        lead = (variant.t_start - window.t_min) / window.duration
        return float(np.clip(1.0 - lead, 0.0, 1.0))

    @staticmethod
    def mem_headroom(variant: Variant, window: Window, *, grid: int = 32) -> float:
        """ψ_mem_headroom = E[(c_k − RAM_i(t)) / c_k] over I(v)  (paper §4.2)."""
        if window.capacity <= 0:
            return 0.0
        mu, _ = variant.fmp.grid(grid)
        headroom = (window.capacity - mu) / window.capacity
        return float(np.clip(np.mean(headroom), 0.0, 1.0))

    @staticmethod
    def energy(energy_joules: float, energy_max: float) -> float:
        """ψ_energy = 1 − E(v)/E_max."""
        if energy_max <= 0:
            return 1.0
        return float(np.clip(1.0 - energy_joules / energy_max, 0.0, 1.0))


# ---------------------------------------------------------------------------
# Composite scoring (Eq. 4) — scalar and pooled/vectorized forms
# ---------------------------------------------------------------------------


def job_utility(features: Mapping[str, float], policy: ScoringPolicy) -> float:
    """h̃(v) = Σ α_i φ_i(v) over the features the variant declares."""
    total = 0.0
    for name, alpha in policy.alphas.items():
        phi = float(features.get(name, 0.0))
        if not (-1e-9 <= phi <= 1.0 + 1e-9):
            raise ValueError(f"feature {name}={phi} outside [0,1]")
        total += alpha * np.clip(phi, 0.0, 1.0)
    return float(total)


def system_utility(
    variant: Variant,
    window: Window,
    policy: ScoringPolicy,
    *,
    age: float = 0.0,
    extra: Optional[Mapping[str, float]] = None,
) -> float:
    """f̃_sys(v) = Σ β_j ψ_j(v) + β_age · A_i(t)   (paper §4.2 + §4.3)."""
    psis: Dict[str, float] = {
        "utilization": SystemFeatures.utilization(variant, window),
        "slack": SystemFeatures.slack(variant, window),
        "mem_headroom": SystemFeatures.mem_headroom(variant, window),
        "age": float(np.clip(age, 0.0, 1.0)),
    }
    if extra:
        psis.update({k: float(np.clip(v, 0.0, 1.0)) for k, v in extra.items()})
    total = 0.0
    for name, beta in policy.betas.items():
        total += beta * psis.get(name, 0.0)
    return float(total)


def composite_score(h_tilde: float, f_sys: float, lam: float) -> float:
    """Eq. 4: Score(v) = λ h̃ + (1−λ) f̃_sys, guaranteed ∈ [0,1]."""
    s = lam * h_tilde + (1.0 - lam) * f_sys
    return float(np.clip(s, 0.0, 1.0))


def score_pool(
    variants: Sequence[Variant],
    window: Window,
    policy: ScoringPolicy,
    *,
    ages: Optional[Mapping[str, float]] = None,
    calibrate: Optional[Callable[[Variant, float], float]] = None,
    extra_sys: Optional[Callable[[Variant], Mapping[str, float]]] = None,
) -> np.ndarray:
    """Score every variant in the pool (Algorithm 1, lines 6–8).

    ``calibrate`` is the §4.2.1 hook: it maps the *declared* h̃(v) to the
    calibrated ĥ(v) (e.g. via ``calibration.Calibrator.calibrate``).
    ``ages`` maps job_id → A_i(t) ∈ [0,1].
    """
    ages = ages or {}
    out = np.zeros(len(variants), dtype=np.float64)
    for idx, v in enumerate(variants):
        h = v.local_utility
        if calibrate is not None:
            h = calibrate(v, h)
        f = system_utility(
            v,
            window,
            policy,
            age=ages.get(v.job_id, 0.0),
            extra=extra_sys(v) if extra_sys else None,
        )
        out[idx] = composite_score(h, f, policy.lam)
    return out


class ScoreHandle:
    """A possibly in-flight batched scoring launch.

    The device paths (the CUDA kernel / its plain torch version) return a
    torch tensor that is still being computed on the current stream;
    :meth:`result` copies it to the host, which waits for it.  The
    pipeline (core/pipeline.py) launches round k, overlaps host work for
    round k+1 while the scores are in flight, and settles k via
    ``result()``.  The numpy small-pool path is eager (already a host
    array) so ``result()`` is free.

    Device handles keep the BUCKET-PADDED score tensor (``m`` marks the real
    pool size, sliced off at ``result()``): the fused settle launch
    (``core.wis.RoundSelector.predispatch``) gathers selection weights from
    :attr:`device_scores`, which stays on the card -- pool indices are
    always < m ≤ m_pad, so padding never leaks into a selection.  A device
    fault surfaces from ``result()`` as it is: there is no host fallback
    that could hide it.
    """

    def __init__(self, scores, m: Optional[int] = None):
        self._scores = scores
        self._m = m

    @property
    def in_flight(self) -> bool:
        """True while the scores are still a device tensor (worth overlapping)."""
        return not isinstance(self._scores, np.ndarray)

    @property
    def device_scores(self):
        """The raw (possibly padded, possibly in-flight) score tensor."""
        return self._scores

    def result(self) -> np.ndarray:
        if not isinstance(self._scores, np.ndarray):
            # the copy to the host waits for the launch to land
            arr = self._scores.to("cpu").numpy().astype(np.float64)
            self._scores = arr[: self._m] if self._m is not None else arr
        return self._scores


def score_round_async(
    variants: Sequence[Variant],
    windows: Sequence[Window],
    win_idx,
    policy: ScoringPolicy,
    *,
    ages: Optional[Mapping[str, float]] = None,
    calibrate: Optional[Callable[[Variant, float], float]] = None,
    impl: Optional[str] = None,
    grid: int = 32,
    recheck_theta: Optional[float] = None,
    per_agent_theta: bool = False,
    grid_cache=None,
    view=None,
    mesh=None,
    health=None,
    device=None,
) -> ScoreHandle:
    """Pack + launch one pooled round; return without blocking on scores.

    Same contract as :func:`score_round` but the device computation is left
    in flight on the current CUDA stream: call ``.result()`` on the
    returned :class:`ScoreHandle` to materialize.  This is the dispatch
    half the round pipeline overlaps with the next round's host-side work.
    ``view`` (types.PoolView aligned with ``variants``) skips the remaining
    per-variant python walks when the caller already built one.
    ``device`` is where the device backends run (None = the CUDA card;
    ``"cpu"`` only when asked).  ``mesh`` sharding is not ported yet and
    must be None.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded scoring is not ported yet (single device only)")
    m = len(variants)
    if m == 0:
        return ScoreHandle(np.zeros(0, dtype=np.float64))
    # lazy import: keeps the numpy-only control plane importable without torch
    from ..kernels.jasda_score.ops import pool_to_arrays_round

    if calibrate is None and view is not None:
        h = view.local_utility  # already a float64 column; no python walk
    else:
        h = np.empty(m, dtype=np.float64)
        for i, v in enumerate(variants):
            h[i] = calibrate(v, v.local_utility) if calibrate is not None else v.local_utility
    # θ precedence: a scheduler-wide recheck_theta overrides the per-agent
    # bounds; per_agent_theta alone gathers each bid's OWN declared θ
    # (Variant.theta, set from AgentConfig.theta at generation) into
    # PackedRound.thetas so heterogeneous agents recheck heterogeneously.
    recheck = recheck_theta is not None or per_agent_theta
    if recheck_theta is not None:
        theta = recheck_theta
    elif per_agent_theta:
        theta = (view.thetas if view is not None
                 else np.asarray([v.theta for v in variants], np.float64))
    else:
        theta = 1.0
    packed = pool_to_arrays_round(
        variants, windows, np.asarray(win_idx), policy,
        h=h, ages=ages, grid=grid, pack_grids=recheck,
        theta=theta, cache=grid_cache,
        view=view,
    )
    def _numpy_scores() -> np.ndarray:
        # host float64 reference: the ladder's last rung, also the small-
        # pool fast path.  Ranks match the legacy per-window path.
        if recheck:
            from ..kernels.jasda_score.ops import score_variants_numpy

            scores, _, _ = score_variants_numpy(
                packed.fj, packed.fs, packed.alphas, packed.betas,
                packed.mu, packed.sg,
                lam=policy.lam, capacity=packed.caps, theta=packed.thetas,
            )
            return np.asarray(scores, np.float64)
        hh = np.clip(packed.fj @ packed.alphas, 0.0, 1.0)
        ff = np.clip(packed.fs @ packed.betas, 0.0, 1.0)
        return policy.lam * hh + (1.0 - policy.lam) * ff

    if impl is None and m < SMALL_POOL_M:
        # device-launch overhead dominates tiny pools; same math on host
        impl = "numpy"
    if impl is None:
        # the auto choice follows the device: the kernel on the card, its
        # plain torch version when the caller asked for the CPU
        from ..kernels.common import resolve_device

        impl = "cuda" if resolve_device(device).type == "cuda" else "torch"
    dev_impl = impl
    if dev_impl != "numpy" and health is not None:
        dev_impl = health.resolve(dev_impl)
    if dev_impl == "numpy":
        return ScoreHandle(_numpy_scores())

    from ..kernels.common import KernelDispatchError
    from ..kernels.jasda_score.ops import score_variants

    # trim=False keeps the bucket-padded device tensor on the handle: the
    # fused settle launch gathers weights from it shape-stably (padded rows
    # are self-masking, and result() slices back to m on the host).  With
    # a BackendHealth attached, an INJECTED dispatch fault marks the
    # backend sick (sticky) and the round re-dispatches one rung down,
    # bottoming out at the host numpy path.  A real build or launch failure
    # is a RuntimeError and propagates.
    while True:
        try:
            scores, _, _ = score_variants(
                packed.fj, packed.fs, packed.alphas, packed.betas,
                packed.mu, packed.sg,
                lam=policy.lam,
                capacity=packed.caps if recheck else 1.0,
                theta=packed.thetas if recheck else 1.0,
                impl=dev_impl,
                trim=False,
                device=device,
            )
            return ScoreHandle(scores, m=m)
        except KernelDispatchError as exc:
            if health is None:
                raise
            health.mark_failed(exc.backend, str(exc))
            dev_impl = health.resolve(exc.backend)
            if dev_impl == "numpy":
                return ScoreHandle(_numpy_scores())


def score_round(
    variants: Sequence[Variant],
    windows: Sequence[Window],
    win_idx,
    policy: ScoringPolicy,
    *,
    ages: Optional[Mapping[str, float]] = None,
    calibrate: Optional[Callable[[Variant, float], float]] = None,
    impl: Optional[str] = None,
    grid: int = 32,
    recheck_theta: Optional[float] = None,
    per_agent_theta: bool = False,
    grid_cache=None,
    view=None,
    mesh=None,
    device=None,
) -> np.ndarray:
    """Score a pooled ROUND of bids with ONE batched dispatch (Eq. 4).

    Semantically equivalent to running :func:`score_pool` per window over
    each window's sub-pool, but the union of all bids is packed into
    struct-of-arrays (``kernels/jasda_score.pool_to_arrays_round``) and
    scored in a single vectorized call — the CUDA kernel on the card, its
    plain torch version on the CPU (``impl`` forces a path).  Calibration (§4.2.1) is a
    host-side per-job transform, applied before packing.

    Safety (condition (a)) was already enforced at variant generation; pass
    ``recheck_theta`` to RE-verify it in-dispatch against each bid's OWN
    window capacity (per-variant capacities, heterogeneous slices): unsafe
    variants score 0 and never enter clearing.  ``per_agent_theta=True``
    rechecks against each bid's OWN agent θ (``Variant.theta``) instead of
    one scheduler-wide bound; an explicit ``recheck_theta`` overrides it.
    All three backends (numpy / torch / cuda) implement identical
    recheck semantics.

    ``win_idx[i]`` gives the index into ``windows`` that variant i bids on.
    ``impl``: None = auto (host numpy below ``SMALL_POOL_M`` bids, else
    the kernel on a CUDA ``device`` / the plain torch version on the CPU),
    or "numpy" | "torch" | "cuda" to force.
    ``grid_cache`` optionally reuses FMP grid discretizations across rounds
    (see ``kernels.jasda_score.ops.FMPGridCache``).
    Returns float scores aligned with ``variants``.
    """
    return score_round_async(
        variants, windows, win_idx, policy,
        ages=ages, calibrate=calibrate, impl=impl, grid=grid,
        recheck_theta=recheck_theta, per_agent_theta=per_agent_theta,
        grid_cache=grid_cache, view=view, mesh=mesh, device=device,
    ).result()

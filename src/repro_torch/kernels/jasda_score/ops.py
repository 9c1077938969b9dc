"""Scoring dispatch: padding + bucketed launch, plus the host-side packing.

The port's counterpart of ``repro/kernels/jasda_score/ops.py``.  λ,
capacity and θ are runtime operands -- scalars or per-variant vectors --
and M is padded to power-of-two buckets (min ``MIN_BUCKET_M``), so round k
with 700 bids and round k+1 with 900 both run at the 1024-row shape.
Padded rows are self-masking (capacity 0 with μ = 1 > 0 and σ = 0 is a
deterministic violation → ineligible, score 0) and sliced off before
returning unless ``trim=False``.

Backends: ``"cuda"`` is the hand-written kernel (kernel.py), ``"torch"``
its plain torch version (ref.py), both on a torch device; ``"numpy"`` is
the host float64 path (:func:`score_variants_numpy`).

``pool_to_arrays_round`` packs a pooled auction round into struct-of-arrays
form with a single python walk over the pool; FMP grid discretizations are
memoized in a bounded :class:`FMPGridCache` scoped per scheduler / per round.
These host-side helpers are the reference's, unchanged.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..common import build_counts as _build_counts
from ..common import check_dispatch_fault, resolve_device
from .kernel import LAUNCHES as _CUDA_LAUNCHES
from .kernel import score_variants_cuda
from .ref import score_variants_reference

__all__ = [
    "score_variants",
    "score_variants_numpy",
    "pool_to_arrays",
    "pool_to_arrays_round",
    "PackedRound",
    "FMPGridCache",
    "MIN_BUCKET_M",
    "bucket_m",
    "build_counts",
    "launch_counts",
]

# Smallest M-bucket: pools below this pad up to one shared shape; above,
# buckets double (256, 512, 1024, ...).
MIN_BUCKET_M = 256


def build_counts() -> dict:
    """nvcc builds of the scoring kernel in this process (at most one:
    the kernel is not specialised per bucket, so pool sizes never rebuild)."""
    return {"cuda": _build_counts().get("jasda_score", 0)}


def launch_counts() -> dict:
    """Launches of the scoring kernel so far (the wrapper's counter)."""
    return {"cuda": _CUDA_LAUNCHES["jasda_score"]}


def bucket_m(m: int) -> int:
    """Pad target for a pool of ``m`` rows: next power of two, min bucket."""
    return max(MIN_BUCKET_M, 1 << int(np.ceil(np.log2(max(m, 1)))))


def _pad_rows(x: np.ndarray, m_pad: int, fill: float = 0.0) -> np.ndarray:
    if x.shape[0] == m_pad:
        return x
    pad = np.full((m_pad - x.shape[0],) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad], axis=0)


def _per_variant_np(x, m: int, fill_value: float = 0.0,
                    m_pad: Optional[int] = None,
                    dtype=np.float32) -> np.ndarray:
    """Scalar / (M,) / (M,1) runtime parameter → padded (m_pad,) host array.

    The single host-side normalizer for λ/capacity/θ -- every numpy path
    (bucketed dispatch padding, the small-pool scorer, round packing) goes
    through it so the accepted shapes can never drift apart.
    """
    m_pad = m_pad or m
    out = np.full(m_pad, fill_value, dtype)
    x = np.asarray(x, dtype)
    out[:m] = x if x.ndim == 0 else x.reshape(-1)
    return out


def score_variants(
    feat_job,
    feat_sys,
    alphas,
    betas,
    mu,
    sigma,
    *,
    lam,
    capacity,
    theta,
    impl: Optional[str] = None,
    bucket: bool = True,
    trim: bool = True,
    device=None,
    mesh=None,
):
    """Batched scoring launch on ``device`` (the card unless asked).

    ``lam`` / ``capacity`` / ``theta`` accept scalars (broadcast over the
    pool) or per-variant ``(M,)`` vectors.  ``impl``: ``"cuda"`` (the
    kernel) or ``"torch"`` (its plain version); None picks ``"cuda"`` on a
    CUDA device and ``"torch"`` on the CPU.  With ``bucket=True`` M is
    padded to a power-of-two bucket.

    Returns ``(score, eligible, p_exceed)`` as torch tensors on ``device``,
    aligned with the input rows; ``p_exceed`` is None on the kernel path
    (not materialized in-kernel).  ``trim=False`` returns the full
    BUCKET-PADDED tensors instead (padded rows score 0 / ineligible by
    construction): the fused settle gathers from that shape-stable form.
    Nothing is synchronised: the tensors are in flight on the current
    stream.  ``mesh`` (multi-device sharding) is not ported yet and raises.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded scoring is not ported yet (single device only)")
    dev = resolve_device(device)
    if impl is None:
        impl = "cuda" if dev.type == "cuda" else "torch"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"score impl must be 'cuda' or 'torch', got {impl!r}")

    feat_job = np.asarray(feat_job, np.float32)
    feat_sys = np.asarray(feat_sys, np.float32)
    m = feat_job.shape[0]
    m_pad = bucket_m(m) if bucket else m
    # padded rows: capacity 0 with mu 1 > 0 and sigma 0 is a deterministic
    # violation -> ineligible by construction regardless of theta
    host = {
        "fj": _pad_rows(feat_job, m_pad),
        "fs": _pad_rows(feat_sys, m_pad),
        "al": np.asarray(alphas, np.float32),
        "be": np.asarray(betas, np.float32),
        "mu": _pad_rows(np.asarray(mu, np.float32), m_pad, fill=1.0),
        "sg": _pad_rows(np.asarray(sigma, np.float32), m_pad, fill=0.0),
        "lam": _per_variant_np(lam, m, 0.0, m_pad),
        "cap": _per_variant_np(capacity, m, 0.0, m_pad),
        "th": _per_variant_np(theta, m, 0.0, m_pad),
    }
    # injected faults fire before the device is touched; a real build or
    # launch failure is a plain RuntimeError and is never caught here
    check_dispatch_fault(impl, "score_variants", (m_pad, host["fj"].shape[1]))
    d = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in host.items()}
    end = m if trim else m_pad
    if impl == "torch":
        score, elig, p_exceed = score_variants_reference(
            d["fj"], d["fs"], d["al"], d["be"], d["mu"], d["sg"],
            lam=d["lam"], capacity=d["cap"], theta=d["th"])
        return score[:end], elig[:end], p_exceed[:end]
    score, elig = score_variants_cuda(
        d["fj"], d["fs"], d["al"], d["be"], d["mu"], d["sg"],
        d["lam"], d["cap"], d["th"])
    return score[:end], elig[:end], None


def score_variants_numpy(
    feat_job,
    feat_sys,
    alphas,
    betas,
    mu,
    sigma,
    *,
    lam,
    capacity,
    theta,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host numpy path with semantics identical to ref.py / the kernel.

    Used below ``scoring.SMALL_POOL_M`` where one device launch costs more
    than the whole matmul; float64 so near-ties rank like the legacy
    per-window path.  Returns ``(score, eligible, p_exceed)``.
    """
    from scipy.special import log_ndtr as _log_ndtr

    fj = np.asarray(feat_job, np.float64)
    fs = np.asarray(feat_sys, np.float64)
    m = fj.shape[0]
    lam_v = _per_variant_np(lam, m, dtype=np.float64)
    cap_v = _per_variant_np(capacity, m, dtype=np.float64)
    th_v = _per_variant_np(theta, m, dtype=np.float64)

    h = np.clip(fj @ np.asarray(alphas, np.float64), 0.0, 1.0)
    f = np.clip(fs @ np.asarray(betas, np.float64), 0.0, 1.0)
    score = lam_v * h + (1.0 - lam_v) * f

    mu = np.asarray(mu, np.float64)
    sg = np.asarray(sigma, np.float64)
    cap_c = cap_v[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.where(sg > 0, (cap_c - mu) / np.maximum(sg, 1e-300),
                     np.where(mu <= cap_c, np.inf, -np.inf))
    logphi = np.where(np.isposinf(z), 0.0, _log_ndtr(np.where(np.isposinf(z), 0.0, z)))
    log_surv = np.sum(logphi, axis=-1)
    p_exceed = -np.expm1(log_surv)
    eligible = p_exceed <= th_v
    return np.where(eligible, score, 0.0), eligible, p_exceed


def _pack_job_features(variants, policy, dtype=np.float32):
    """Declared job features + α vector in the (jct, qos, progress) order the
    kernel contract fixes — single source of truth for both packing paths."""
    fj = np.zeros((len(variants), 3), dtype)
    for i, v in enumerate(variants):
        d = v.declared_features
        fj[i] = [d.get("jct", 0.0), d.get("qos", 0.0), d.get("progress", 0.0)]
    alphas = np.array(
        [policy.alphas.get("jct", 0.0), policy.alphas.get("qos", 0.0),
         policy.alphas.get("progress", 0.0)], dtype)
    return fj, alphas


def pool_to_arrays(
    variants,
    window,
    policy,
    *,
    grid: int = 32,
) -> Tuple[np.ndarray, ...]:
    """Host-side helper: struct-of-arrays feature/FMP matrices for a pool.

    Feature order must match the α/β vectors built here (job: jct, qos,
    progress; sys: utilization, slack, age placeholder 0 — ages are added by
    the caller when known).
    """
    m = len(variants)
    fj, alphas = _pack_job_features(variants, policy)
    fs = np.zeros((m, 3), np.float32)
    mu = np.zeros((m, grid), np.float32)
    sg = np.zeros((m, grid), np.float32)
    for i, v in enumerate(variants):
        util = min(1.0, v.duration / max(window.duration, 1e-9))
        lead = max(0.0, (v.t_start - window.t_min) / max(window.duration, 1e-9))
        fs[i] = [util, 1.0 - lead, 0.0]
        mu[i], sg[i] = v.fmp.grid(grid)
    betas = np.array(
        [policy.betas.get("utilization", 0.0), policy.betas.get("slack", 0.0),
         policy.betas.get("age", 0.0)], np.float32)
    return fj, fs, alphas, betas, mu, sg


# ---------------------------------------------------------------------------
# Round packing: the union of every window's bids in ONE struct-of-arrays
# ---------------------------------------------------------------------------


class FMPGridCache:
    """Bounded LRU of FMP grid discretizations, scoped per scheduler/round.

    Replaces the former process-global ``functools.lru_cache`` on the mean-mu
    helper, which retained FMP objects (and their grids) across unrelated
    scheduler instances and benchmark runs for the life of the process.  One
    instance lives on each ``JasdaScheduler``; stateless callers get a fresh
    per-call (per-round) cache.

    Entries are keyed by ``(fmp, n_grid)`` (PhaseFMP is frozen/hashable) and
    hold ``(mu_f32, sigma_f32, mean_mu_f64)`` — the f32 copies feed the
    device pack directly, the float64 mean feeds the ψ_mem_headroom feature
    with the same precision as the legacy per-window path.
    """

    def __init__(self, maxsize: int = 1024):
        self.maxsize = max(1, int(maxsize))
        self._d: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def grid(self, fmp, n: int) -> Tuple[np.ndarray, np.ndarray, float]:
        key = (fmp, n)
        hit = self._d.get(key)
        if hit is not None:
            self.hits += 1
            self._d.move_to_end(key)
            return hit
        self.misses += 1
        mu64, sg64 = fmp.grid(n)
        entry = (
            np.asarray(mu64, np.float32),
            np.asarray(sg64, np.float32),
            float(np.mean(mu64)),
        )
        self._d[key] = entry
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
        return entry

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        self._d.clear()


class PackedRound(NamedTuple):
    """Struct-of-arrays form of one pooled auction round.

    ``caps``/``thetas`` are per-variant: ``caps[i]`` is the capacity of the
    window variant i bids on (gathered via ``win_idx``), so the kernel can
    re-verify safety condition (a) in-kernel against heterogeneous slices.
    """

    fj: np.ndarray  # (M, Fj) float64 job features (or calibrated h column)
    fs: np.ndarray  # (M, Fs) float64 system features
    alphas: np.ndarray  # (Fj,) float64
    betas: np.ndarray  # (Fs,) float64
    mu: np.ndarray  # (M, T) float32 FMP means (T=1 zeros when grids unpacked)
    sg: np.ndarray  # (M, T) float32 FMP stds
    caps: np.ndarray  # (M,) float64 per-variant window capacity
    thetas: np.ndarray  # (M,) float64 per-variant safety bound


def pool_to_arrays_round(
    variants,
    windows,
    win_idx,
    policy,
    *,
    h=None,
    ages=None,
    grid: int = 32,
    pack_grids: bool = False,
    theta=1.0,
    cache: Optional[FMPGridCache] = None,
    view=None,
) -> PackedRound:
    """Pack a pooled ROUND of bids for one batched scoring dispatch.

    Each variant is scored against ITS OWN window (``win_idx[i]`` indexes
    ``windows``); the returned :class:`PackedRound` carries the per-variant
    window capacities and θ so the kernel re-verifies safety condition (a)
    per window.  System features mirror ``scoring.score_pool`` exactly:
    [utilization, slack, mem_headroom, age], so the batched call reproduces
    the per-window numpy path.

    ``h`` (optional, (M,)) is the pre-calibrated job utility ĥ(v); when given
    the job side collapses to a single feature column with α = [1.0], which
    is how the round path injects §4.2.1 calibration without a per-variant
    device round-trip.  ``pack_grids=False`` skips the (M, T) FMP grids (the
    in-kernel safety recheck is a no-op when generation already enforced
    condition (a)); pass True to re-verify with ``theta`` (scalar broadcast
    or per-variant vector).  ``cache`` memoizes FMP grid discretizations —
    pass the scheduler's :class:`FMPGridCache` to reuse grids across rounds;
    None uses a fresh per-call cache.

    The pool is walked at most ONCE in python (``view`` — a
    ``types.PoolView`` aligned with ``variants`` — skips even that); grids
    and grid statistics are gathered from the cache by unique FMP, so a
    round over thousands of variants sharing a few job FMPs touches each
    grid once.  Within the round, FMPs are deduplicated by object identity
    (cheap) and only the per-unique-FMP cache lookups hash the frozen
    dataclass.

    Features stay float64 on the host so the small-pool numpy scoring path
    ranks variants exactly like the legacy per-window path even on near-ties;
    the device launch (:func:`score_variants`) downcasts to float32 at the
    device boundary.
    """
    m = len(variants)
    win_idx = np.asarray(win_idx)
    w_tmin = np.asarray([w.t_min for w in windows], np.float64)[win_idx]
    w_dur = np.asarray([max(w.duration, 1e-9) for w in windows], np.float64)[win_idx]
    w_cap = np.asarray([w.capacity for w in windows], np.float64)[win_idx]

    if cache is None:
        cache = FMPGridCache(maxsize=max(64, m))

    # -- at most one pool walk: scalars + unique-FMP gather -------------------
    if view is not None:
        t_start = view.t_start
        dur = view.duration
        fmp_list = view.fmps
        job_ids = view.job_ids
    else:
        rows = [(v.t_start, v.duration, v.fmp, v.job_id) for v in variants]
        ts, ds, fmp_list, job_ids = zip(*rows) if rows else ((), (), (), ())
        t_start = np.asarray(ts, np.float64)
        dur = np.asarray(ds, np.float64)
        fmp_list = list(fmp_list)
        job_ids = list(job_ids)
    fmp_row = np.empty(m, np.intp)
    row_of: dict = {}  # id(fmp) -> row (identity dedup: no dataclass hashing)
    uniq = []  # [(mu_f32, sg_f32, mean_mu)]
    for i, fmp in enumerate(fmp_list):
        r = row_of.get(id(fmp))
        if r is None:
            r = len(uniq)
            row_of[id(fmp)] = r
            uniq.append(cache.grid(fmp, grid))
        fmp_row[i] = r
    if ages:
        get_age = ages.get
        age = np.asarray([get_age(j, 0.0) for j in job_ids], np.float64)
    else:
        age = np.zeros(m, np.float64)

    util = np.clip(dur / w_dur, 0.0, 1.0)
    slack = np.clip(1.0 - (t_start - w_tmin) / w_dur, 0.0, 1.0)
    mean_mu = np.asarray([u[2] for u in uniq], np.float64)[fmp_row] if m else \
        np.zeros(0, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        headroom = np.where(
            w_cap > 0, np.clip(1.0 - mean_mu / np.where(w_cap > 0, w_cap, 1.0), 0.0, 1.0), 0.0
        )
    fs = np.stack([util, slack, headroom, np.clip(age, 0.0, 1.0)], axis=1)
    betas = np.array(
        [policy.betas.get("utilization", 0.0), policy.betas.get("slack", 0.0),
         policy.betas.get("mem_headroom", 0.0), policy.betas.get("age", 0.0)],
        np.float64)

    if h is not None:
        fj = np.asarray(h, np.float64)[:, None]
        alphas = np.array([1.0], np.float64)
    else:
        fj, alphas = _pack_job_features(variants, policy, dtype=np.float64)

    if pack_grids and m:
        mu_tab = np.stack([u[0] for u in uniq])
        sg_tab = np.stack([u[1] for u in uniq])
        mu = mu_tab[fmp_row]
        sg = sg_tab[fmp_row]
    else:
        # sigma=0 with mu=0 <= capacity is deterministically safe: the
        # kernel's eligibility mask becomes a no-op, as intended
        mu = np.zeros((m, 1), np.float32)
        sg = np.zeros((m, 1), np.float32)

    thetas = _per_variant_np(theta, m, dtype=np.float64)
    return PackedRound(fj, fs, alphas, betas, mu, sg, w_cap, thetas)

"""Plain float64 reference of one JASDA auction round (paper §4.1–§4.4).

A round's answer is the set of awards: which bids win each announced
window once every bid is scored (Eq. 4 with the FMP safety check) and each
window is cleared by weighted interval scheduling, with the cross-window
conflicts resolved greedily (a job keeps its best-scored wins, the windows
that lose a winner are cleared again, until nothing changes).

The reference follows the program's round from the round's bids: their
intervals, jobs and chunk work, and two columns of the program's own
state, the calibrated job utility ``h`` and each job's age term.  It works
out again from the benchmark's own data everything else the program
derives: each bid's system features (utilisation of its window, slack,
memory headroom), the memory profile of its job on the safety grid, and
the window capacities.  Then it scores, clears and resolves in float64.

:func:`judge` holds one captured round of the program to it:

* ``score_gap``: the widest gap between a bid's score on the program's
  timed path and the reference's;
* ``award_gap``: the widest gap, as a share of the reference round's
  total, between the reference's awards and the program's, both valued at
  the reference's scores;
* ``violations``: awards that break a constraint whatever the scores
  (outside their window, overlapping another award of their window or of
  their job, or past the job's work budget).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

OVERLAP_EPS = 1e-12  # two awards closer than this do not overlap
TIME_EPS = 1e-9  # an award may protrude this far past its window


def fmp_grid(steady: np.ndarray, n: int, *, warmup_frac: float = 0.1,
             burst_frac: float = 0.05, rel_sigma: float = 0.03):
    """(mu, sigma) of ``fmp_standard(0.3 s, s, 0.1 s)`` at the ``n`` cell
    midpoints of [0, 1], for each steady memory ``s`` (bytes): a linear
    warm-up ramp from 0.3 s to s, a steady phase at s, a burst at 1.1 s;
    sigma is ``rel_sigma`` times each phase's top."""
    s = np.asarray(steady, np.float64)[:, None]
    t = (np.arange(n, dtype=np.float64) + 0.5) / n
    steady_frac = 1.0 - warmup_frac - burst_frac
    edges = (warmup_frac, warmup_frac + steady_frac)
    ramp = 0.3 * s + (t - 0.0) / warmup_frac * (s - 0.3 * s)
    mu = np.where(t < edges[0], ramp, np.where(t < edges[1], s, 1.1 * s))
    sg = np.where(t < edges[1], rel_sigma * s, rel_sigma * 1.1 * s)
    return mu * np.ones_like(t), sg * np.ones_like(t)


def score(fj, fs, alphas, betas, lam, mu=None, sg=None, cap=None, theta=None,
          *, dtype=torch.float64) -> np.ndarray:
    """Eq. 4 and, where grids are given, the grid safety check:
    ``score = lam clip(fj a, 0, 1) + (1 - lam) clip(fs b, 0, 1)``, zeroed
    where ``1 - prod_t Phi((cap - mu_t) / sigma_t)`` exceeds ``theta``.
    Computed in ``dtype`` (float64 for the reference; a lower precision
    for the control); returned as float64."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(dtype)

    h = torch.clamp(t(fj) @ t(alphas), 0.0, 1.0)
    f = torch.clamp(t(fs) @ t(betas), 0.0, 1.0)
    lam_t = t(lam)
    out = lam_t * h + (1.0 - lam_t) * f
    if mu is not None:
        mu_t, sg_t = t(mu), t(sg)
        cap_t = t(cap).reshape(-1, 1) if np.ndim(cap) else t(cap)
        z = (cap_t - mu_t) / torch.clamp(sg_t, min=1e-30)
        det = torch.where(mu_t <= cap_t, torch.zeros((), dtype=dtype),
                          torch.full((), float("-inf"), dtype=dtype))
        wide = torch.float64 if dtype == torch.float64 else torch.float32
        logphi = torch.where(sg_t <= 0, det,
                             torch.special.log_ndtr(z.to(wide)).to(dtype))
        p_exceed = -torch.expm1(logphi.sum(dim=1))
        out = torch.where(p_exceed <= t(theta), out, torch.zeros((), dtype=dtype))
    return out.to(torch.float64).numpy()


def wis(starts: np.ndarray, ends: np.ndarray, weights: np.ndarray) -> List[int]:
    """Indices of a maximum-weight set of disjoint intervals (sorted by end;
    a predecessor is the last interval ending at or before a start; an
    interval is taken only where it strictly adds, so ties keep fewer)."""
    order = np.argsort(ends, kind="stable")
    s, e, w = starts[order], ends[order], weights[order]
    pred = np.searchsorted(e, s, side="right")
    m = len(order)
    dp = np.zeros(m + 1)
    take = np.zeros(m, bool)
    for j in range(m):
        with_j = w[j] + dp[pred[j]]
        take[j] = with_j > dp[j]
        dp[j + 1] = with_j if take[j] else dp[j]
    sel, j = [], m
    while j > 0:
        if take[j - 1]:
            sel.append(int(order[j - 1]))
            j = int(pred[j - 1])
        else:
            j -= 1
    return sel


def settle(n_windows: int, win_idx, t_start, t_end, job_ids, work,
           budget: Optional[Dict[str, float]], scores) -> List[List[int]]:
    """Greedy fixed point: clear every window, then let each job keep its
    best-scored wins (ties: earlier start, then lower window) that neither
    overlap a kept win in another window nor pass its work budget; the
    windows that lost a win are cleared again without the banned bids."""
    members = [[] for _ in range(n_windows)]
    for i, k in enumerate(win_idx):
        members[int(k)].append(i)
    banned = np.zeros(len(scores), bool)
    selected: List[List[int]] = [[] for _ in range(n_windows)]
    dirty = list(range(n_windows))
    while True:
        for k in dirty:
            idx = np.asarray([i for i in members[k] if not banned[i]], np.intp)
            selected[k] = ([] if idx.size == 0 else
                           [int(idx[j]) for j in wis(t_start[idx], t_end[idx],
                                                     scores[idx])])
        dirty = []
        wins: Dict[str, List[int]] = {}
        for k in range(n_windows):
            for i in selected[k]:
                wins.setdefault(job_ids[i], []).append(i)
        for job, mine in wins.items():
            mine.sort(key=lambda i: (-scores[i], t_start[i], win_idx[i]))
            kept, used = [], 0.0
            cap = None if budget is None else budget.get(job)
            for i in mine:
                drop = any(t_start[i] < t_end[j] - OVERLAP_EPS
                           and t_start[j] < t_end[i] - OVERLAP_EPS
                           and win_idx[i] != win_idx[j] for j in kept)
                if not drop and cap is not None:
                    if used + work[i] > cap + 1e-9:
                        drop = True
                    else:
                        used += work[i]
                if drop:
                    banned[i] = True
                    if win_idx[i] not in dirty:
                        dirty.append(int(win_idx[i]))
                else:
                    kept.append(i)
        if not dirty:
            return selected


def features(rnd: dict) -> dict:
    """The score inputs the reference works out again for one round."""
    win = rnd["windows"]  # (W, 3): capacity, t_min, duration
    k = rnd["win_idx"]
    w_cap, w_tmin, w_dur = win[k, 0], win[k, 1], win[k, 2]
    dur = rnd["t_end"] - rnd["t_start"]
    mu, sg = fmp_grid(rnd["steady"], rnd["grid"])
    util = np.clip(dur / w_dur, 0.0, 1.0)
    slack = np.clip(1.0 - (rnd["t_start"] - w_tmin) / w_dur, 0.0, 1.0)
    headroom = np.where(w_cap > 0, np.clip(
        1.0 - mu.mean(axis=1) / np.where(w_cap > 0, w_cap, 1.0), 0.0, 1.0), 0.0)
    fs = np.stack([util, slack, headroom, np.clip(rnd["age"], 0.0, 1.0)], 1)
    return {"fs": fs, "mu": mu, "sg": sg, "cap": w_cap}


def reference_scores(rnd: dict, policy: dict, *, dtype=torch.float64):
    f = features(rnd)
    betas = [policy["betas"][n] for n in ("utilization", "slack",
                                          "mem_headroom", "age")]
    grids = rnd["theta"] is not None
    return score(rnd["h"][:, None], f["fs"], [1.0], betas, policy["lam"],
                 f["mu"] if grids else None, f["sg"] if grids else None,
                 f["cap"], rnd["theta"], dtype=dtype)


def violations(rnd: dict, sel: Sequence[Sequence[int]]) -> int:
    """Awards that break a constraint whatever the scores."""
    ts, te, k = rnd["t_start"], rnd["t_end"], rnd["win_idx"]
    win = rnd["windows"]
    jobs = rnd["job_ids"]
    bad = 0
    flat = []
    for w, idx in enumerate(sel):
        for i in idx:
            if k[i] != w or ts[i] < win[w, 1] - TIME_EPS or \
                    te[i] > win[w, 1] + win[w, 2] + TIME_EPS:
                bad += 1
            flat.append(i)
    if len(set(flat)) != len(flat):
        bad += len(flat) - len(set(flat))
    used: Dict[str, float] = {}
    for a in range(len(flat)):
        i = flat[a]
        used[jobs[i]] = used.get(jobs[i], 0.0) + rnd["work"][i]
        for b in range(a + 1, len(flat)):
            j = flat[b]
            same_window = k[i] == k[j]
            if (same_window or jobs[i] == jobs[j]) and \
                    ts[i] < te[j] - OVERLAP_EPS and ts[j] < te[i] - OVERLAP_EPS:
                bad += 1
    for job, w in used.items():
        if w > rnd["budget"].get(job, 0.0) + 1e-9:
            bad += 1
    return bad


def judge(rnd: dict, policy: dict, *, scores_under_test=None,
          awards_under_test=None) -> dict:
    """The three numbers of one captured round (module docstring).  The
    program's scores and awards are judged unless others are given (the
    control puts its own in their place)."""
    ref = reference_scores(rnd, policy)
    got = rnd["scores"] if scores_under_test is None else scores_under_test
    sel = rnd["awards"] if awards_under_test is None else awards_under_test
    n_w = rnd["windows"].shape[0]
    ref_sel = settle(n_w, rnd["win_idx"], rnd["t_start"], rnd["t_end"],
                     rnd["job_ids"], rnd["work"], rnd["budget"], ref)
    best = float(sum(ref[i] for s in ref_sel for i in s))
    mine = float(sum(ref[i] for s in sel for i in s))
    return {
        "score_gap": float(np.max(np.abs(np.asarray(got) - ref))) if len(ref) else 0.0,
        "award_gap": abs(best - mine) / max(best, 1e-12),
        "violations": violations(rnd, sel),
    }


def control(rnd: dict, policy: dict, dtype=torch.bfloat16) -> dict:
    """The reference in the program's place at ``dtype`` (bfloat16: the
    precision below the program's float32 scoring), settled on its own
    scores, judged as the program is."""
    low = reference_scores(rnd, policy, dtype=dtype)
    sel = settle(rnd["windows"].shape[0], rnd["win_idx"], rnd["t_start"],
                 rnd["t_end"], rnd["job_ids"], rnd["work"], rnd["budget"], low)
    return judge(rnd, policy, scores_under_test=low, awards_under_test=sel)

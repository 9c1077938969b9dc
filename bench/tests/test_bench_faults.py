"""The comparison that decides ``correct`` catches a broken timed path:
each run skips the look for a card, breaks the program underneath, and
must come out not correct.  And the control (the reference in the
program's place, one precision lower) must fail the cell's limits."""
import numpy as np
import pytest

from bench import harness
from bench.tests.small import run_small

STREAM = "mig-pod64.stream"
TRAIN, CHAT = "falcon-mamba-7b-32l.train-jasda", "falcon-mamba-7b.chat32"


def _halve_scores(monkeypatch):
    """Half of the pool left out of the scoring launch: its scores are 0."""
    from repro_torch.kernels.jasda_score import ops

    inner = ops.score_variants

    def broken(*a, **kw):
        score, elig, p = inner(*a, **kw)
        score = score.clone()
        score[score.shape[0] // 2:] = 0.0
        return score, elig, p

    monkeypatch.setattr(ops, "score_variants", broken)


def _settle(monkeypatch, alter):
    from repro_torch.core.policy import greedy

    inner = greedy.fixed_point_settle

    def broken(windows, fit, win_idx, scores, **kw):
        rr = inner(windows, fit, win_idx, scores, **kw)
        return alter(rr, win_idx)

    monkeypatch.setattr(greedy, "fixed_point_settle", broken)


def _swap_one_award(rr, win_idx):
    """An award altered where it is made: a window's first winner replaced
    by a bid of the same window that lost."""
    sel = [list(s) for s in rr.selected_idx]
    for k, s in enumerate(sel):
        losers = [i for i in np.flatnonzero(np.asarray(win_idx) == k)
                  if i not in s]
        if s and losers:
            s[0] = int(losers[0])
            break
    rr.selected_idx = tuple(tuple(s) for s in sel)
    return rr


def _no_awards(rr, win_idx):
    """The round returns the state unchanged: nothing awarded."""
    rr.selected_idx = tuple(() for _ in rr.selected_idx)
    return rr


@pytest.mark.parametrize("fault", ["half_scored", "award_altered", "nothing_awarded"])
def test_auction_faults_are_caught(monkeypatch, fault):
    if fault == "half_scored":
        _halve_scores(monkeypatch)
    else:
        _settle(monkeypatch, _swap_one_award if fault == "award_altered"
                else _no_awards)
    result, h = run_small(STREAM, seed=31)
    assert not result["correct"], result["checks"]


def test_train_state_left_unchanged_is_caught(monkeypatch):
    from repro_torch.training import trainer

    monkeypatch.setattr(trainer, "apply_updates", lambda params, updates: params)
    result, h = run_small(TRAIN, seed=32)
    assert not result["correct"], result["checks"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_is_caught(monkeypatch):
    from repro_torch.models import model

    inner = model.softmax_cross_entropy

    def half(logits, labels, **kw):
        b = logits.shape[0] // 2
        return inner(logits[:b], labels[:b], **kw)

    monkeypatch.setattr(model, "softmax_cross_entropy", half)
    result, h = run_small(TRAIN, seed=33, batch=4)
    assert not result["correct"], result["checks"]


def test_served_token_altered_is_caught(monkeypatch):
    from repro_torch.serving.engine import ServingEngine

    inner = ServingEngine._pick

    def altered(self, logits):
        return (inner(self, logits) + 1) % logits.shape[0]

    monkeypatch.setattr(ServingEngine, "_pick", altered)
    result, h = run_small(CHAT, seed=34)
    assert not result["correct"], result["checks"]
    # judged by its tokens: requests were checked, and their gap fails
    checks = result["checks"]
    assert checks["requests_unchecked"]["value"] == 0, checks
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"], checks


@pytest.mark.parametrize("cell", [STREAM, TRAIN, CHAT])
def test_control_fails_the_limits(cell):
    result, h = run_small(cell, seed=35)
    assert result["correct"], result["checks"]
    ctl = harness.driver(h.cell["driver"]).control(h)
    assert any(v > h.limits[k] for k, v in ctl.items()), (ctl, h.limits)

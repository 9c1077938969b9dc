"""The port's hand-written CUDA kernels against their plain versions, on
the card.

Each case runs one kernel on seeded inputs at a shape its main path
launches and holds it to the plain torch version of ``kernels/*/ref.py``:
K1 (``jasda_score``) and K2 (``wis_batch``) bit for bit, with K2's
backtrack on each row the one ``ref.climbing_rows`` predicts; K3 (the
single-window ``wis_dp``) bit for bit on each of its three branches; K5
(``linear_scan``) and its backward bit for bit; K4 (``flash_attention``)
at the shapes of ``torch_card.ATTN_CASES`` within 2e-5 in float32 and 2e-2
in bfloat16 entry by entry (the largest error also within 2e-5 and 1e-2 of
the largest output), and on partial last key tiles; its tensor-core
kernel also within 1e-2 of ``mha_tiled_reference``, which models its
tiles; and the auction mesh's row-sharded launches of K1 and K2 bit for
bit.  Nothing is timed: speed is the benchmark's (``bench/run.py``).
Every test skips without a card (``tests/torch_card.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.wis import wis_select
from repro_torch.kernels import wis_clear
from repro_torch.kernels.common import check_launch
from repro_torch.kernels.flash_attention import kernel as k4
from repro_torch.kernels.flash_attention import ref as k4_ref
from repro_torch.kernels.jasda_score import kernel as k1
from repro_torch.kernels.jasda_score import ops as score_ops
from repro_torch.kernels.jasda_score import ref as k1_ref
from repro_torch.kernels.linear_scan import kernel as k5
from repro_torch.kernels.linear_scan import ref as k5_ref
from repro_torch.kernels.wis_dp import kernel as k2
from repro_torch.kernels.wis_dp import ops as wis_ops
from repro_torch.kernels.wis_dp import ref as k2_ref
from repro_torch.launch.mesh import make_auction_mesh
from torch_card import (ATTN_CASES, ATTN_TOL, bits, card,  # noqa: F401
                        held_to_plain, within)

pytestmark = pytest.mark.card


def _stream():
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# K1: the Eq. 4 score and the FMP safety check
# ---------------------------------------------------------------------------

def score_inputs(dev, m: int, t: int, n_pad: int, seed: int):
    """Round-path operands: one job feature (alpha = [1]), four system
    features, T grid points, caps and thresholds apart row by row, ~10%
    sigma = 0 points, and ``n_pad`` pad rows last as ``ops.score_variants``
    writes them."""
    rng = np.random.default_rng(seed)
    fj = rng.uniform(0, 1, (m, 1)).astype(np.float32)
    fs = rng.uniform(0, 1, (m, 4)).astype(np.float32)
    al = np.array([1.0], np.float32)
    be = np.array([0.4, 0.2, 0.1, 0.2], np.float32)
    cap = rng.uniform(15.0, 25.0, m).astype(np.float32)
    # most rows sit well under their cap, some brush it (their sigma = 0
    # points are certain violations)
    risk = rng.uniform(0.6, 1.03, (m, 1))
    mu = (cap[:, None] * risk * rng.uniform(0.7, 1.0, (m, t))).astype(np.float32)
    sg = (cap[:, None] * rng.uniform(0.0, 0.06, (m, t))).astype(np.float32)
    sg[rng.uniform(size=(m, t)) < 0.1] = 0.0
    lam = rng.uniform(0.2, 0.8, m).astype(np.float32)
    theta = rng.uniform(0.01, 0.3, m).astype(np.float32)
    pad = slice(m - n_pad, m)
    fj[pad], fs[pad], mu[pad], sg[pad] = 0.0, 0.0, 1.0, 0.0
    lam[pad] = cap[pad] = theta[pad] = 0.0
    return [torch.from_numpy(a).to(dev)
            for a in (fj, fs, al, be, mu, sg, lam, cap, theta)]


def plain_scores(args):
    return k1_ref.score_variants_reference(*args[:6], lam=args[6],
                                           capacity=args[7], theta=args[8])


#: (M, T, pad rows): the round path's largest pool, then rows x grid points
#: that do not fill K1's blocks of 128 rows and T past its 32-point pass
K1_CASES = [(32768, 32, 256)] + [(m, t, 16) for m in (256, 1000)
                                 for t in (1, 7, 33, 64)]


@pytest.mark.parametrize("m,t,n_pad", K1_CASES)
def test_k1_is_bit_equal(card, m, t, n_pad):
    args = score_inputs(card, m, t, n_pad, seed=m + t)
    score, elig = k1.score_variants_cuda(*args)
    want, want_elig, _ = plain_scores(args)
    assert torch.equal(elig, want_elig)
    assert torch.equal(bits(score), bits(want))
    assert torch.isfinite(score).all()
    # pad rows mask themselves; the safety check passes some rows, not all
    assert not elig[m - n_pad:].any() and not score[m - n_pad:].any()
    assert 0 < int(elig.sum()) < m - n_pad


# ---------------------------------------------------------------------------
# K2: the batched WIS settle
# ---------------------------------------------------------------------------

def settle_inputs(dev, n_rows: int, lanes: int, m_pad: int, seed: int, *,
                  zero_rows: int = 0, masked_row=None):
    """(W, L) end-sorted lanes over a pool of ``m_pad`` rows: idx (-1 on
    ~20% pads), predecessors from a float64 stable sort, a transform.  The
    first ``zero_rows`` rows get ~30% zero-length intervals (pred past the
    lane); ``masked_row`` has every lane masked."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m_pad, (n_rows, lanes)).astype(np.int32)
    idx[rng.random((n_rows, lanes)) < 0.2] = -1
    if masked_row is not None:
        idx[masked_row] = -1
    starts = rng.integers(0, 4 * lanes, (n_rows, lanes)) / 2.0
    ends = starts + rng.integers(1, 64, (n_rows, lanes)) / 2.0
    if zero_rows:
        zero = rng.random((n_rows, lanes)) < 0.3
        zero[zero_rows:] = False
        ends = np.where(zero, starts, ends)
    order = np.argsort(ends, axis=1, kind="stable")
    e_s = np.take_along_axis(ends, order, axis=1)
    s_s = np.take_along_axis(starts, order, axis=1)
    pred = np.stack([np.searchsorted(e_s[k], s_s[k], side="right")
                     for k in range(n_rows)]).astype(np.int32)
    transform = (1.0 + rng.random(m_pad) * 0.5).astype(np.float32)
    t = {"idx": idx, "mask": idx >= 0, "pred": pred, "transform": transform}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in t.items()}


def pool_scores(dev):
    """K1's plain scores of the round path's largest pool: what K2 gathers."""
    return plain_scores(score_inputs(dev, 32768, 32, 256, seed=0))[0]


#: (W, L, form, options): the round path's first pass and a re-clear,
#: L = 1000 with an all-masked row, zero-length intervals in half the rows,
#: a row past 48 KB of shared memory and one past the limit
K2_CASES = [
    (64, 2048, "fused", {}), (64, 2048, "fused+transform", {}),
    (64, 2048, "batched", {}), (8, 2048, "batched", {}),
    (64, 1000, "fused", {"masked_row": 5}),
    (64, 2048, "fused+transform", {"zero_rows": 32}),
    (64, 16384, "fused+transform", {}), (64, 32768, "fused", {}),
]


def k2_branch(lanes: int, dev) -> str:
    if not k2.uses_shared_memory(lanes, dev):
        return "global scratch"
    return "shared > 48 KB" if k2.row_bytes(lanes) > 48 * 1024 else "shared"


def walked_rows(dev, pred, *, w=None, scores=None, t=None, transform=None):
    """K2 once more through ``wis_batch_launch_paths``: its selections,
    totals, and on each row whether it backtracked by the bounded walk
    (True) or by pointer doubling, as the kernel reports it."""
    def ptr(x):
        return None if x is None else x.data_ptr()

    n_rows, lanes = pred.shape
    sel = torch.empty((n_rows, lanes), dtype=torch.bool, device=dev)
    tot = torch.empty((n_rows,), dtype=torch.float32, device=dev)
    paths = torch.full((n_rows,), 2, dtype=torch.uint8, device=dev)
    scratch = None
    if not k2.uses_shared_memory(lanes, dev):
        scratch = torch.empty((n_rows * k2.row_bytes(lanes),),
                              dtype=torch.uint8, device=dev)
    fused = w is None
    check_launch(k2._lib().wis_batch_launch_paths(
        ptr(w), ptr(scores), ptr(transform), ptr(t["idx"]) if fused else None,
        ptr(t["mask"]) if fused else None, pred.data_ptr(), n_rows, lanes,
        int(scores.shape[0]) if fused else 0, sel.data_ptr(), tot.data_ptr(),
        ptr(scratch), paths.data_ptr(), _stream()), "wis_batch_launch_paths")
    assert int(paths.max()) <= 1, "a row's backtrack was left unwritten"
    return sel, tot, paths.bool()


@pytest.mark.parametrize("n_rows,lanes,form,opts", K2_CASES,
                         ids=[f"{w}x{n}-{f}" + "".join(f"-{k}" for k in o)
                              for w, n, f, o in K2_CASES])
def test_k2_is_bit_equal_and_backtracks_as_predicted(card, n_rows, lanes,
                                                      form, opts):
    scores = pool_scores(card)
    seed = 1 + K2_CASES.index((n_rows, lanes, form, opts))
    t = settle_inputs(card, n_rows, lanes, int(scores.shape[0]), seed, **opts)
    tr = t["transform"] if form == "fused+transform" else None
    w = k2_ref.fused_weights(scores, t["idx"], t["mask"], tr)
    if form == "batched":
        sel, tot = k2.wis_batch_cuda(t["pred"], weights=w)
        again = walked_rows(card, t["pred"], w=w)
    else:
        sel, tot = k2.wis_batch_cuda(t["pred"], scores=scores, idx=t["idx"],
                                     mask=t["mask"], transform=tr)
        again = walked_rows(card, t["pred"], scores=scores, t=t, transform=tr)
    want_sel, want_tot = k2_ref.wis_batch_reference(w, t["pred"])
    assert torch.equal(sel, want_sel)
    assert torch.equal(bits(tot), bits(want_tot))
    assert int(sel.sum()) and torch.isfinite(tot).all()
    if "masked_row" in opts:
        row = opts["masked_row"]
        assert not sel[row].any() and tot[row] == 0
    assert torch.equal(again[0], sel) and torch.equal(bits(again[1]), bits(tot))
    _, take = k2_ref.wis_forward_reference(w, t["pred"])
    walked = again[2]
    assert torch.equal(walked, k2_ref.climbing_rows(take, t["pred"]))
    if "zero_rows" in opts:
        assert 0 < int(walked.sum()) <= opts["zero_rows"]


def test_k2_cases_reach_every_branch(card):
    assert {k2_branch(lanes, card) for _, lanes, _, _ in K2_CASES} == {
        "shared", "shared > 48 KB", "global scratch"}


# ---------------------------------------------------------------------------
# K5: the linear scan, forward and backward
# ---------------------------------------------------------------------------

def scan_inputs(dev, b: int, t: int, d: int, dtype, seed: int):
    """Decays in (0.8, 1), inputs ~ N(0, 0.01), h0 ~ N(0, 1), drawn on the card."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    a = torch.rand((b, t, d), generator=g, device=dev) * 0.199 + 0.8
    x = torch.randn((b, t, d), generator=g, device=dev) * 0.1
    h0 = torch.randn((b, d), generator=g, device=dev)
    return a.to(dtype), x.to(dtype), h0.to(dtype)


#: falcon-mamba's d_inner x ssm_state
MAMBA_D = 8192 * 16
F32, BF16 = torch.float32, torch.bfloat16
#: (B, T, D, dtype, h0): the mamba prefill's widths, the RG-LRU width, bf16
K5_CASES = [(1, t, MAMBA_D, F32, h0) for t in (1, 37, 512, 1024)
            for h0 in (True, False)] + [(1, 512, 4096, F32, False),
                                        (2, 256, 8192, BF16, False)]
#: (B, T, D, dtype, h0 and a cotangent on h_T): the training shape
K5_BWD_CASES = [(4, 512, MAMBA_D, F32, True), (4, 512, MAMBA_D, F32, False),
                (1, 37, MAMBA_D, F32, True), (1, 512, 4096, F32, False),
                (2, 256, 8192, BF16, False)]


def _scan_id(case):
    b, t, d, dtype, h0 = case
    return f"{b}x{t}x{d}-{str(dtype)[6:]}" + ("-h0" if h0 else "")


@pytest.mark.parametrize("case", K5_CASES, ids=_scan_id)
def test_k5_is_bit_equal(card, case):
    b, t, d, dtype, with_h0 = case
    a, x, h0 = scan_inputs(card, b, t, d, dtype, seed=t + d)
    h0 = h0 if with_h0 else None
    out, h_t = k5.linear_scan_cuda(a, x, h0)
    want, want_t = k5_ref.linear_scan_reference(a, x, h0)
    assert torch.equal(bits(out), bits(want))
    assert torch.equal(bits(h_t), bits(want_t))
    assert torch.isfinite(out).all() and torch.isfinite(h_t).all()


@pytest.mark.parametrize("case", K5_BWD_CASES, ids=_scan_id)
def test_k5_backward_is_bit_equal(card, case):
    b, t, d, dtype, with_h0 = case
    a, x, h0 = scan_inputs(card, b, t, d, dtype, seed=b + t + d)
    g = torch.Generator(device=card)
    g.manual_seed(b * t)
    gh = torch.randn((b, t, d), generator=g, device=card).to(dtype)
    ghT = torch.randn((b, d), generator=g, device=card) if with_h0 else None
    h0 = h0 if with_h0 else None
    h, _ = k5.linear_scan_cuda(a, x, h0)
    got = k5.linear_scan_bwd_cuda(a, h, h0, gh, ghT)
    want = k5_ref.linear_scan_bwd_reference(a, h, h0, gh, ghT)
    for part, u, v in zip(("da", "db", "dh0"), got, want):
        assert (u is None) == (v is None) == (part == "dh0" and not with_h0), part
        if u is not None:
            assert torch.equal(bits(u), bits(v)), part
            assert torch.isfinite(u).all(), part


# ---------------------------------------------------------------------------
# K4: flash attention
# ---------------------------------------------------------------------------

#: the tensor-core kernel against its tiled model: one bf16 rounding apart
ATTN_TILED_TOL = 1e-2
#: non-causal (B, Hq, Hkv, Sq, Sk, D) whose last key tile is partial: the
#: tensor-core kernel's tile of keys is 64 at D = 64 and 256, 128 at 128
ATTN_PAD_CASES = [(4, 12, 12, 4, 1500, 64), (4, 12, 12, 1500, 1500, 64),
                  (2, 64, 8, 2048, 1600, 128)]
ATTN_TILE_KEYS = {64: 64, 128: 128, 256: 64}


def _attn_id(case):
    b, hq, hkv, sq, sk, d, dt, causal, window, off = case
    return (f"{b}x{hq}x{sq}x{d}-kv{hkv}-sk{sk}-{dt}"
            + ("-causal" if causal else "") + (f"-w{window}" if window else "")
            + (f"-off{off}" if off else ""))


@pytest.mark.parametrize("case", ATTN_CASES, ids=_attn_id)
def test_k4_is_within_tolerance_on_the_path_it_names(card, case):
    b, hq, hkv, sq, sk, d, dt, causal, window, off = case
    dtype = getattr(torch, dt)
    lib = k4._lib()
    path = lib.flash_attention_path(k4._DTYPES[dtype], d)
    # bf16 at D = 64, 128, 256 takes the tensor cores (1), the rest not (0)
    assert path == int(dt == "bfloat16" and d in (64, 128, 256))
    g = torch.Generator(device=card)
    g.manual_seed(sq + sk + hq)
    q, k, v = (torch.randn(shape, generator=g, device=card).to(dtype)
               for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    kw = dict(causal=causal, window=window, q_offset=off)
    out = k4.mha_cuda(q, k, v, **kw)
    assert torch.isfinite(out).all()
    assert held_to_plain(out, k4_ref.mha_reference(q, k, v, **kw))
    if path:
        assert within(out, k4_ref.mha_tiled_reference(q, k, v, **kw),
                      ATTN_TILED_TOL)
    # the branch ``flash_attention_path`` names is the one that ran
    forced = torch.empty_like(q)
    check_launch(lib.flash_attention_launch_on(
        path, q.data_ptr(), k.data_ptr(), v.data_ptr(), forced.data_ptr(), b,
        hq, hkv, sq, sk, d, k4._DTYPES[dtype], int(causal), window or 0, off,
        1.0 / d ** 0.5, _stream()), "flash_attention_launch_on")
    assert torch.equal(bits(forced), bits(out))


@pytest.mark.parametrize("case", ATTN_PAD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_k4_masks_a_partial_last_key_tile(card, case):
    """q ~ N(2, 1) and k ~ N(-2, 1) put every real logit near -4 sqrt(D),
    the zeros past Sk would give logit 0, and v ~ N(8, 1): keys left
    unmasked (the plain version over K and V zero-padded to whole tiles)
    miss the tolerance on every entry, and the kernel meets it on all."""
    b, hq, hkv, sq, sk, d = case
    pad = -sk % ATTN_TILE_KEYS[d]
    assert pad, "the last key tile is whole"
    g = torch.Generator(device=card)
    g.manual_seed(sq + sk)
    q, k, v = ((torch.randn(shape, generator=g, device=card) + mean)
               .to(torch.bfloat16) for shape, mean in (
                   ((b, hq, sq, d), 2.0), ((b, hkv, sk, d), -2.0),
                   ((b, hkv, sk, d), 8.0)))
    want = k4_ref.mha_reference(q, k, v, causal=False).float()
    zeros = torch.zeros((b, hkv, pad, d), dtype=q.dtype, device=card)
    fault = k4_ref.mha_reference(q, torch.cat([k, zeros], 2),
                                 torch.cat([v, zeros], 2), causal=False).float()
    tol = ATTN_TOL["bfloat16"]
    assert bool(((fault - want).abs() > tol + tol * want.abs()).all())
    assert within(k4.mha_cuda(q, k, v, causal=False), want, tol)


# ---------------------------------------------------------------------------
# K3: the single-window WIS
# ---------------------------------------------------------------------------

def dp_window(m: int, seed: int, *, specials: bool = False):
    """One end-sorted window: weights in [0, 1), predecessors from a
    searchsorted over the sorted ends.  ``specials`` makes ~10% of the
    intervals zero-length (pred past the lane) and puts -0, negative, +-inf
    and NaN weights among the rest."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 1, m).astype(np.float32)
    ends = np.sort(rng.uniform(0, 100, m))
    starts = ends - rng.uniform(0.5, 20, m)
    if specials:
        starts = np.where(rng.random(m) < 0.1, ends, starts)
        pick = rng.random(m)
        for lo, v in ((0.0, -0.0), (0.02, -0.5), (0.06, np.inf),
                      (0.062, -np.inf), (0.065, np.nan)):
            w = np.where((pick >= lo) & (pick < lo + 0.02), np.float32(v), w)
        w = w.astype(np.float32)
    pred = np.searchsorted(ends, starts, side="right").astype(np.int32)
    return torch.from_numpy(w), torch.from_numpy(pred)


def assert_dp_held(w, p, dp, take):
    """dp bit-equal and take equal to the plain version's, run on the host
    (the same float32 loop)."""
    want_dp, want_take = k2_ref.wis_dp_reference(w.cpu(), p.cpu())
    assert torch.equal(bits(dp.cpu()), bits(want_dp))
    assert torch.equal(take.cpu().bool(), want_take)


#: windows around K3's pipeline depth, the reference's range (2048; 16384
#: past 48 KB of shared memory; 65536 in a cluster of 2), a cluster of 6
#: (preds reaching back two blocks) and one past what a cluster of 8 holds
DP_SIZES = [1, 2, 3, 5, 7, 2048, 16384, 65536, 300_000, 450_000]
DP_FORCED_M = 16384


@pytest.mark.parametrize("m", DP_SIZES)
def test_k3_is_bit_equal(card, m):
    w, p = (x.to(card) for x in dp_window(m, seed=m))
    dp, take = k2.wis_dp_cuda(w, p)
    assert_dp_held(w, p, dp, take)
    assert int(take.sum()) and torch.isfinite(dp).all()


def test_k3_sizes_reach_every_branch(card):
    assert {k2.wis_dp_plan(m)[0] for m in DP_SIZES} == {0, 1, 2}


@pytest.mark.parametrize("kind", ["specials", "misaligned"])
def test_k3_is_bit_equal_on_odd_windows(card, kind):
    """Zero-length intervals and -0, negative, +-inf and NaN weights; and
    views 4 bytes past 16-byte alignment (the wrapper copies them for the
    kernel's bulk copies)."""
    w, p = (x.to(card) for x in dp_window(2048, seed=49,
                                          specials=kind == "specials"))
    if kind == "misaligned":
        w, p = w[1:], p[1:]
    assert_dp_held(w, p, *k2.wis_dp_cuda(w, p))


@pytest.mark.parametrize("path", range(len(k2.DP_PATHS)), ids=k2.DP_PATHS)
def test_k3_is_bit_equal_on_each_forced_branch(card, path):
    m = DP_FORCED_M
    w, p = (x.to(card) for x in dp_window(m, seed=m))
    assert k2.wis_dp_plan(m, path)[0] == path
    dp = torch.empty((m,), dtype=torch.float32, device=card)
    take = torch.empty((m,), dtype=torch.int32, device=card)
    scratch = torch.empty((m + 1,), dtype=torch.float32, device=card)
    check_launch(k2._lib().wis_dp_launch_on(
        path, w.data_ptr(), p.data_ptr(), m, dp.data_ptr(), take.data_ptr(),
        scratch.data_ptr() if path == 2 else None, _stream()),
        "wis_dp_launch_on")
    assert_dp_held(w, p, dp, take)


def test_wis_clear_on_the_card_is_wis_select(card):
    rng = np.random.default_rng(45)
    sizes = (1, 12, 300, 2048)
    before = k2.LAUNCHES["wis_dp"]
    for m in sizes:
        starts = rng.uniform(0, 100, m)
        ends = starts + rng.uniform(0.5, 30, m)
        weights = rng.uniform(0.0, 1.0, m)
        sel, total = wis_clear(starts, ends, weights, impl="cuda", device=card)
        sel_t, total_t = wis_clear(starts, ends, weights, impl="torch",
                                   device="cpu")
        sel_h, total_h = wis_select(starts, ends, weights)
        assert sel.tolist() == sel_t.tolist() and total == total_t
        assert set(sel.tolist()) == set(sel_h.tolist())
        assert abs(total - total_h) <= 1e-5 * max(1.0, abs(total_h))
    assert k2.LAUNCHES["wis_dp"] - before == len(sizes)


# ---------------------------------------------------------------------------
# The auction mesh: K1 and K2 launched once a row shard
# ---------------------------------------------------------------------------

MESH_SHARDS = 4


def test_sharded_k1_is_one_launch(card):
    m = 1 << 20
    args = score_inputs(card, m, 32, 256, seed=0)
    host = [a.cpu().numpy() for a in args]
    kw = dict(lam=host[6], capacity=host[7], theta=host[8], impl="cuda",
              trim=False)
    mesh = make_auction_mesh(MESH_SHARDS, devices=[card] * MESH_SHARDS)
    before = k1.LAUNCHES["jasda_score"]
    whole = score_ops.score_variants(*host[:6], device=card, **kw)
    assert k1.LAUNCHES["jasda_score"] - before == 1
    split = score_ops.score_variants(*host[:6], mesh=mesh, **kw)
    assert k1.LAUNCHES["jasda_score"] - before == 1 + MESH_SHARDS
    want, want_elig, _ = plain_scores(args)
    for score, elig in (split[:2], (want, want_elig)):
        assert torch.equal(bits(score), bits(whole[0]))
        assert torch.equal(elig, whole[1])


@pytest.mark.parametrize("n_rows,form", [(64, "fused"), (64, "fused+transform"),
                                         (8, "batched")])
def test_sharded_k2_is_one_launch(card, n_rows, form):
    scores = pool_scores(card)
    ins = settle_inputs(card, n_rows, 2048, int(scores.shape[0]),
                        seed=70 + n_rows)
    tr = ins["transform"] if form == "fused+transform" else None
    w = k2_ref.fused_weights(scores, ins["idx"], ins["mask"], tr)
    mesh = make_auction_mesh(MESH_SHARDS, devices=[card] * MESH_SHARDS)

    def settle(on):
        if form == "batched":
            return wis_ops.wis_settle_batch(w, ins["pred"], impl="cuda",
                                            device=card, mesh=on)
        return wis_ops.wis_settle_fused(scores, ins["idx"], ins["mask"],
                                        ins["pred"], impl="cuda", mesh=on,
                                        transform=tr)

    before = k2.LAUNCHES["wis_batch"]
    one = settle(None)
    assert k2.LAUNCHES["wis_batch"] - before == 1
    four = settle(mesh)
    assert k2.LAUNCHES["wis_batch"] - before == 1 + MESH_SHARDS
    for sel, tot in (four, k2_ref.wis_batch_reference(w, ins["pred"])):
        assert torch.equal(sel, one[0])
        assert torch.equal(bits(tot), bits(one[1]))
    assert int(one[0].sum())

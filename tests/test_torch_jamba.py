"""AI21-Jamba2-Mini on the port, against its plain float32 reference.

``tests/reference/jamba.py`` is the published forward pass in plain torch,
one sequence, one scan step at a time; it imports nothing of the port.  At
a small size on the CPU (``configs.reduced("jamba2_mini")``: one 8-layer
period, d_model 128, 4 heads over 2 KV heads, 4 of 8 experts held, vocab
2048, the mixer's chunks cut to 16 tokens; float32 throughout) the port's full
forward, its prefill then decode through the serving engine's cache, its
chunked mixer, its expert shares and its dropless routing are held to it.
``bench/reference/jamba.py``, the benchmark's copy computed in blocks, is
held to it too.

Tolerances: both sides compute in float32 and differ in the order of
their sums (the scan composed by K5's loop or by doubling against one step
at a time, einsums against matmuls, the chunked prefill), a few ulps of
the logits' scale (about 1); 1e-4 absolute leaves room for that and fails
on any term left out (a missing norm or expert moves logits by 1e-1 or
more here).
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, PORTED, get, reduced
from repro_torch.models import Model, ssm
from repro_torch.models.moe import moe_dropless, moe_ffn, route
from repro_torch.models.ssm import mamba_seq
from repro_torch.runtime import trace
from repro_torch.serving import Request, ServeConfig, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the benchmark's copy imports ``bench``
    sys.path.insert(0, str(ROOT))
ATOL = 1e-4


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("jamba_reference", ROOT / "tests" / "reference" / "jamba.py")


def ref_config(cfg):
    """The reference's sizes from the port's config: the published periods
    and offsets of the layer types."""
    return {"norm_eps": cfg.norm_eps, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
            "conv": cfg.ssm_conv, "state": cfg.ssm_state,
            "dt_rank": cfg.dt_rank_actual, "top_k": cfg.top_k,
            "held": cfg.held, "attn_layer_period": 8, "attn_layer_offset": 4,
            "expert_layer_period": 2, "expert_layer_offset": 1}


def ref_params(params, cfg):
    """The port's stacked tree as the reference's list of layers (views),
    its ``1 + scale`` norms as weights."""
    sb = cfg.superblock
    layers = []
    for i in range(cfg.n_layers):
        kind = sb[i % len(sb)]
        blk = params["blocks"][f"b{i % len(sb)}_{kind}"]
        s = i // len(sb)
        p = {"ln1": 1 + blk["ln1_scale"][s], "ln2": 1 + blk["ln2_scale"][s]}
        if kind == "attn":
            a = blk["attn"]
            d = a["wq"].shape[1]
            p.update(wq=a["wq"][s].reshape(d, -1), wk=a["wk"][s].reshape(d, -1),
                     wv=a["wv"][s].reshape(d, -1),
                     wo=a["wo"][s].reshape(-1, d))
        else:
            m = {k: v[s] for k, v in blk["mamba"].items()}
            p.update(in_proj=m["in_proj"].reshape(m["in_proj"].shape[0], -1),
                     conv_w=m["conv_w"], conv_b=m["conv_b"], x_proj=m["x_proj"],
                     dt_proj=m["dt_proj"], dt_bias=m["dt_bias"],
                     A_log=m["a_log"], D=m["d_skip"], out_proj=m["out_proj"],
                     dt_norm=1 + m["dt_norm"], b_norm=1 + m["b_norm"],
                     c_norm=1 + m["c_norm"])
        ffn = blk["moe"] if kind == "mamba_moe" else blk["mlp"]
        p.update({k: v[s] for k, v in ffn.items()})
        layers.append(p)
    return {"embed": params["embed"], "unembed": params["unembed"],
            "final_norm": 1 + params["final_norm"], "layers": layers}


def _live(params, seed=3):
    """Norm scales, conv biases and D drawn away from their init (0, 0, 1),
    so a skipped norm or term shows."""
    g = torch.Generator().manual_seed(seed)

    def go(tree, name=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                go(v, k)
            elif k.endswith(("_scale", "_norm", "conv_b", "d_skip")) or k == "final_norm":
                v.add_(0.3 * torch.randn(v.shape, generator=g))
    go(params)
    return params


@pytest.fixture(autouse=True)
def few_threads():
    """Two of the host's threads: the suite runs on several workers at
    once, and these small ops lose more to idle pool threads than they
    gain."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def short_chunks(monkeypatch):
    """The mixer's chunks of 16 tokens (2048 at the served size), so that
    the prompts here run the chunked prefill."""
    monkeypatch.setattr(ssm, "CHUNK", 16)


@pytest.fixture(scope="module")
def small():
    cfg = reduced("jamba2_mini")
    model = Model(cfg)
    params = _live(model.init(0, device="cpu"))
    return cfg, model, params


def _tokens(n, seed=0, vocab=2048):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, n))


def test_registered_as_the_ports_own():
    assert "jamba2_mini" in PORTED and "jamba2_mini" not in ARCH_NAMES
    cfg = get("jamba2_mini")
    assert cfg.layer_kinds.count("attn") == 4
    assert cfg.layer_kinds.count("mamba_moe") == 16
    assert [i for i, k in enumerate(cfg.layer_kinds) if k == "attn"] == [4, 12, 20, 28]
    assert cfg.param_count() == 51_569_598_336  # published: 52B total
    assert cfg.active_param_count() == 12_109_586_304  # published: 12B active
    card = cfg.replace(held_experts=(0, 8))
    assert card.param_count() == 29_021_020_032  # 58.0 GB in bfloat16
    # of the two experts a token picks, one lands here on average
    assert card.active_param_count() == card.param_count() - 16 * 7 * 3 * 4096 * 14336


def test_full_forward_matches_the_reference(small):
    cfg, model, params = small
    rc, rp = ref_config(cfg), ref_params(params, cfg)
    toks = torch.stack([_tokens(40, 1), _tokens(40, 2)])
    with torch.no_grad():
        got, _ = model.forward(params, toks)
    for row in range(2):
        want = REF.logits(rp, toks[row], rc)
        np.testing.assert_allclose(got[row].numpy(), want.numpy(), atol=ATOL)


def test_prefill_then_decode_matches_the_full_forward(small):
    """Served through the engine: prompts longer than a mixer chunk (16)
    prefilled into slots at different depths, then decoded together; each
    step's logits of each busy slot against the reference's full forward
    over the prompt and the tokens served before."""
    cfg, model, params = small
    rc, rp = ref_config(cfg), ref_params(params, cfg)
    eng = ServingEngine(model, params, ServeConfig(batch_slots=2, max_seq=64),
                        device="cpu")
    steps = []
    decode = eng._decode_slots

    def logged():
        logits, how = decode()
        steps.append((logits.clone(), [r for r in eng.slots]))
        return logits, how

    eng._decode_slots = logged
    reqs = [Request("a", _tokens(37, 4).numpy().astype(np.int32), max_new_tokens=6),
            Request("b", _tokens(21, 5).numpy().astype(np.int32), max_new_tokens=9)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    for req in reqs:
        seq = torch.cat([torch.from_numpy(req.prompt).long(),
                         torch.tensor(req.output[:-1])])
        want = REF.logits(rp, seq, rc)
        got = [lg[b] for lg, slots in steps for b, r in enumerate(slots) if r is req]
        assert len(got) == len(req.output) - 1
        n = len(req.prompt)
        for j, g in enumerate(got):
            np.testing.assert_allclose(g.numpy(), want[n + j].numpy(), atol=ATOL)
    assert model.routed_choices("cpu").sum() > 0


def test_chunked_mixer_matches_one_pass(small, monkeypatch):
    cfg, model, params = small

    def whole(*a, **kw):
        monkeypatch.setattr(ssm, "CHUNK", 10**9)
        try:
            return mamba_seq(*a, **kw)
        finally:
            monkeypatch.setattr(ssm, "CHUNK", 16)

    p = {k: v[0] for k, v in params["blocks"]["b0_mamba_mlp"]["mamba"].items()}
    x = torch.randn(2, 50, cfg.d_model, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        out, state = mamba_seq(x, p, cfg, return_cache=True)
        one, one_state = whole(x, p, cfg, return_cache=True)
    np.testing.assert_allclose(out.numpy(), one.numpy(), atol=1e-5)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(state[k].numpy(), one_state[k].numpy(), atol=1e-5)
    # a pass that records a gradient runs whole
    xg = x.clone().requires_grad_(True)
    assert torch.equal(mamba_seq(xg, p, cfg).detach(), whole(xg, p, cfg).detach())


def _moe_inputs(seed, e=8, d=32, f=48, t=40, rig=None):
    g = torch.Generator().manual_seed(seed)
    p = {"router": torch.randn(d, e, generator=g),
         "w_gate": torch.randn(e, d, f, generator=g) / d ** 0.5,
         "w_up": torch.randn(e, d, f, generator=g) / d ** 0.5,
         "w_down": torch.randn(e, f, d, generator=g) / f ** 0.5}
    x = torch.randn(1, t, d, generator=g)
    if rig is not None:  # every token's first choice: expert ``rig``
        x = x.abs()
        p["router"][:, rig] = 10.0
    return x, p


def _share(p, first, count):
    return {"router": p["router"], **{k: p[k][first:first + count]
                                      for k in ("w_gate", "w_up", "w_down")}}


@pytest.mark.parametrize("static", [False, True], ids=["rows", "static"])
def test_expert_shares_add_up_to_the_whole_layer(static):
    x, p = _moe_inputs(7)
    whole, rows = moe_dropless(x, p, top_k=2, held=(0, 8), static=static)
    parts = [moe_dropless(x, _share(p, f, 4), top_k=2, held=(f, 4), static=static)
             for f in (0, 4)]
    np.testing.assert_allclose((parts[0][0] + parts[1][0]).numpy(), whole.numpy(),
                               atol=1e-5)
    cfg = {"top_k": 2, "held": (0, 8)}
    np.testing.assert_allclose(whole[0].numpy(), REF.moe(x[0], p, cfg).numpy(),
                               atol=1e-5)
    if not static:  # every choice computed once, by one share or the other
        assert rows == 80 and parts[0][1] + parts[1][1] == 80


def test_dropless_loses_no_token():
    """A router rigged so that every token picks expert 3 first: the
    dropless layer computes every choice (as the reference), where the
    GShard path, at its capacity, drops most of them."""
    x, p = _moe_inputs(8, rig=3)
    counts = torch.zeros(8, dtype=torch.int64)
    out, rows = moe_dropless(x, p, top_k=2, held=(0, 8), counts=counts)
    assert rows == 80 and counts[3] == 40 and counts.sum() == 80
    cfg = {"top_k": 2, "held": (0, 8)}
    np.testing.assert_allclose(out[0].numpy(), REF.moe(x[0], p, cfg).numpy(), atol=1e-5)
    static, _ = moe_dropless(x, p, top_k=2, held=(0, 8), static=True)
    np.testing.assert_allclose(static.numpy(), out.numpy(), atol=1e-5)
    r = route(x, p["router"], top_k=2, capacity_factor=1.25)
    assert (~r.keep).sum() > 20
    gshard, _ = moe_ffn(x, p, top_k=2)
    assert (gshard - out).abs().max() > 0.1


def _mamba_seq_before(x, p, cfg):
    """``mamba_seq`` as it was before the mixer norms and the chunked
    prefill (a frozen copy)."""
    from repro_torch.kernels.linear_scan.ops import linear_scan
    from repro_torch.models.ssm import _ssm_inputs, causal_conv1d
    import torch.nn.functional as F

    B, S, _ = x.shape
    Dm, N = cfg.d_inner, cfg.ssm_state
    xz = torch.einsum("bsd,dcm->bscm", x, p["in_proj"])
    x1_raw, z = xz[:, :, 0], xz[:, :, 1]
    x1 = F.silu(causal_conv1d(x1_raw, p["conv_w"], p["conv_b"]))
    dt, a, b_ssm, c_ssm = _ssm_inputs(x1, p, cfg)
    da = torch.exp(dt[..., None] * a)
    dbx = (dt * x1.float())[..., None] * b_ssm[:, :, None, :]
    h, hT = linear_scan(da.reshape(B, S, Dm * N), dbx.reshape(B, S, Dm * N))
    h = h.reshape(B, S, Dm, N)
    y = torch.einsum("bsdn,bsn->bsd", h, c_ssm) + p["d_skip"] * x1.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return torch.einsum("bsm,md->bsd", y, p["out_proj"])


@pytest.mark.parametrize("chunk", [300, 2048])
def test_falcon_mamba_mixer_is_unchanged(chunk, monkeypatch):
    """falcon-mamba (norms off) at bfloat16, its prompt of 300 tokens one
    chunk or less: bit for bit as before."""
    monkeypatch.setattr(ssm, "CHUNK", chunk)
    cfg = reduced("falcon_mamba_7b").replace(dtype=torch.bfloat16)
    assert not cfg.mamba_norms
    params = Model(cfg).init(1, device="cpu")
    p = {k: v[0] for k, v in params["blocks"]["b0_mamba"]["mamba"].items()}
    x = torch.randn(2, 300, cfg.d_model).to(torch.bfloat16)
    with torch.no_grad():
        assert torch.equal(mamba_seq(x, p, cfg), _mamba_seq_before(x, p, cfg))


def test_moe_spans_and_counts(small):
    cfg, model, params = small
    model = Model(cfg)
    with trace.enable():
        trace.reset()
        with torch.no_grad():
            _, cache, _ = model.prefill(params, _tokens(30, 9)[None], max_seq=40)
            model.decode_step(params, torch.tensor([5]), torch.tensor([30]), cache)
        spans = trace.spans("model.moe")
    trace.reset()
    assert [s.attrs["layer"] for s in spans] == [1, 3, 5, 7] * 2
    assert all(s.attrs["tokens"] == 30 for s in spans[:4])
    assert all(0 < s.attrs["rows"] <= 60 for s in spans[:4])
    assert all("rows" not in s.attrs and s.attrs["tokens"] == 1 for s in spans[4:])
    # every choice of every MoE layer counted, 2 a token
    assert int(model.routed_choices("cpu").sum()) == 2 * 4 * (30 + 1)


def test_bench_reference_matches_the_plain_one(small):
    cfg, model, params = small
    bench_ref = _load("bench_jamba_reference", ROOT / "bench" / "reference" / "jamba.py")
    rc, rp = ref_config(cfg), ref_params(params, cfg)
    toks = _tokens(45, 10)
    want = REF.logits(rp, toks, rc)
    pos = [0, 17, 31, 44]
    got = bench_ref.logits_at(rp, toks, rc, pos, scan_block=8, query_block=16)
    np.testing.assert_allclose(got.numpy(), want[pos].numpy(), atol=ATOL)

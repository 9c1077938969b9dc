"""The port's models, launchers and examples on the card.

- Each reduced float32 config on the card (K4 in prefill where asked, K5)
  against the same params on the host, within 1e-4 over a prefill and 8
  decode steps; a MoE config with the card's routing replayed on the host,
  and that routing held to the host's own choices.
- Every served config at full width (two cut in depth), bfloat16: a
  prefill through K4 against the same prefill through ``auto``, then greedy
  decode steps; K4 once an attention layer a prefill, never in decode, and
  only at shapes ``ATTN_CASES`` holds to its plain version.
- Full-width qwen1.5-4b and olmoe-1b-7b with the dry run's sharding rules
  on four virtual shards of the card against the same calls without rules,
  bit for bit.
- The launchers on the card: ``serve_auction`` and ``train`` against the
  same run on the host; ``serve`` at full width, every request finished
  and K4 only at shapes ``ATTN_CASES`` holds.
- The examples: the cluster study's tables (to t = 300) through K1 and K2
  against the plain versions on the host, batched serving through K4
  against ``auto``, and the 100M-parameter model's resume, bit for bit.

Every test skips without a card (``tests/torch_card.py``).
"""
import contextlib
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.store import tree_flatten
from repro_torch.configs import Shape, get, info, reduced
from repro_torch.distributed.sharding import resolve_param_specs
from repro_torch.kernels.flash_attention import kernel as k4
from repro_torch.kernels.flash_attention import ops as k4_ops
from repro_torch.kernels.flash_attention import ref as k4_ref
from repro_torch.kernels.jasda_score import kernel as k1
from repro_torch.kernels.wis_dp import kernel as k2
from repro_torch.launch import serve, serve_auction
from repro_torch.launch.dryrun import build_rules
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model, moe
from repro_torch.models.params import P, build_template
from torch_card import (ATTN_CASES, bits, card,  # noqa: F401  (the fixture)
                        held_to_plain)

pytestmark = pytest.mark.card

ROOT = Path(__file__).resolve().parents[1]
#: a reduced float32 config's largest logit gap, card against host
REDUCED_TOL = 1e-4
#: a card routing choice other than the host's must be a near-tie: the
#: host's router probabilities of the two experts within this much
ROUTE_TIE_TOL = 1e-6
#: the card's gates against the host's where both chose the same experts
ROUTE_GATE_TOL = 1e-6


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def printed(fn, *args, **kw):
    """``fn``'s result and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def k4_per_prefill(cfg) -> int:
    """K4's launches in one prefill through it: once an attention layer."""
    if cfg.family == "encdec":
        return cfg.n_encoder_layers + 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_super * cfg.superblock.count("attn")
    return cfg.n_layers


# ---------------------------------------------------------------------------
# Reduced configs: the card against the host
# ---------------------------------------------------------------------------

class RouteRecorder:
    """While entered, records every ``moe.route`` call: the chosen experts,
    gates, slots, kept choices and capacity on the host, with the router
    probabilities (G, g, E) in float32.  With ``replay`` (another
    recorder's ``calls``) each call's experts, gates, slots and kept
    choices are replaced by that recorder's call of the same index."""

    FIELDS = ("expert", "gate", "slot", "keep")

    def __init__(self, replay=None):
        self.replay, self.calls = replay, []

    def __enter__(self):
        self.route = moe.route

        def spy(xt, router, **kw):
            r = self.route(xt, router, **kw)
            call = {k: getattr(r, k).cpu() for k in self.FIELDS}
            call["capacity"] = r.capacity
            call["probs"] = torch.softmax(xt.float() @ router.float(), -1).cpu()
            if self.replay is not None:
                c = self.replay[len(self.calls)]
                r = r._replace(**{k: c[k].to(xt.device) for k in self.FIELDS})
            self.calls.append(call)
            return r

        moe.route = spy
        return self

    def __exit__(self, *exc):
        moe.route = self.route


def live_params(cfg, params, seed: int) -> None:
    """Draw the leaves the reference draws as zeros from ``seed``, in place
    (LayerNorm scales of ``encdec`` 1 + 0.3 N(0, 1), every other zeros leaf
    0.3 N(0, 1)): with zeros whisper's logits are identically zero and the
    VLM's cross attention reaches nothing."""
    gen = torch.Generator().manual_seed(seed)

    def walk(tpl, p, name):
        if not isinstance(tpl, P):
            for k in tpl:
                walk(tpl[k], p[k], k)
        elif tpl.init == "zeros":
            scale = name.endswith("_scale") or name == "final_norm"
            base = 1.0 if cfg.family == "encdec" and scale else 0.0
            p.copy_(base + 0.3 * torch.randn(p.shape, generator=gen))

    walk(build_template(cfg), params, "")


def plain_slots(expert, capacity: int):
    """Each (group, token, choice)'s place in its expert's queue, counted
    one by one in the reference's order (choice-major, then token), and
    whether it is below ``capacity``."""
    n_groups, g, k = expert.shape
    slot = np.empty_like(expert)
    for grp in range(n_groups):
        taken = {}
        for j in range(k):
            for i in range(g):
                e = int(expert[grp, i, j])
                slot[grp, i, j] = taken.get(e, 0)
                taken[e] = slot[grp, i, j] + 1
    return slot, slot < capacity


def assert_routing_held(card_calls, host_calls):
    """The card's slots and kept choices are its experts' queue places;
    where a token's experts differ from the host's, each rank's two
    experts are a near-tie in the host's probabilities; elsewhere the
    gates agree."""
    for c, h in zip(card_calls, host_calls, strict=True):
        slot, keep = plain_slots(c["expert"].numpy(), c["capacity"])
        assert c["capacity"] == h["capacity"]
        assert np.array_equal(c["slot"].numpy(), slot)
        assert np.array_equal(c["keep"].numpy(), keep)
        apart = (c["expert"] != h["expert"]).any(dim=-1)
        if apart.any():
            pc = h["probs"].gather(-1, c["expert"])[apart]
            ph = h["probs"].gather(-1, h["expert"])[apart]
            assert float((pc - ph).abs().max()) <= ROUTE_TIE_TOL
        same = ~apart[..., None].expand_as(c["gate"])
        assert float(torch.where(same, (c["gate"] - h["gate"]).abs(), 0.0)
                     .max()) <= ROUTE_GATE_TOL


#: (arch, prefill attention): falcon-mamba through K5, the rest through K4
REDUCED = [("falcon_mamba_7b", "auto"), ("recurrentgemma_9b", "pallas"),
           ("olmoe_1b_7b", "pallas"), ("granite_moe_3b_a800m", "pallas"),
           ("qwen3_14b", "pallas"), ("qwen1_5_4b", "pallas"),
           ("starcoder2_15b", "pallas"), ("llama3_405b", "pallas"),
           ("whisper_small", "pallas"), ("llama3_2_vision_90b", "pallas")]


@pytest.mark.parametrize("arch,impl", REDUCED, ids=[a for a, _ in REDUCED])
def test_reduced_config_on_the_card_is_the_host(card, arch, impl):
    """A 32-token prefill of two rows and 8 decode steps, the params drawn
    on the host from one seed.  The MoE combine rounds the gates to
    bfloat16, so a last-bit difference between cuBLAS and the host can
    move a gate by a bfloat16 step or a near-tie's choice: the host runs
    again with the card's routing replayed, and that run is held to 1e-4."""
    cfg = reduced(arch)
    host_params = Model(cfg).init(0, device="cpu")
    rng = np.random.default_rng(REDUCED.index((arch, impl)))
    toks = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    memory = None
    if cfg.family in ("vlm", "encdec"):
        live_params(cfg, host_params, seed=7)
        memory = rng.standard_normal(
            (2, cfg.encoder_seq or cfg.vision_seq, cfg.d_model)).astype(np.float32)

    def run(params, dev, replay=None):
        with RouteRecorder(replay) as rec:
            m = Model(cfg)
            tk = torch.from_numpy(toks).to(dev)
            mem = None if memory is None else torch.from_numpy(memory).to(dev)
            logits, cache, cross = m.prefill(params, tk[:, :32], memory=mem,
                                             impl=impl, max_seq=64)
            seq = [logits.float().cpu()]
            for t in range(32, 40):
                logits, cache = m.decode_step(params, tk[:, t], t, cache,
                                              cross_stack=cross)
                seq.append(logits.float().cpu())
        return torch.stack(seq), rec.calls

    k4.LAUNCHES["flash_attention"] = 0
    on_card, card_calls = run(_to(host_params, card), card)
    assert k4.LAUNCHES["flash_attention"] == (
        k4_per_prefill(cfg) if impl == "pallas" else 0)
    cpu = torch.device("cpu")
    host, host_calls = run(host_params, cpu)
    if card_calls:
        host, host_calls = run(host_params, cpu, replay=card_calls)
        assert_routing_held(card_calls, host_calls)
    assert float((on_card - host).abs().max()) <= REDUCED_TOL


# ---------------------------------------------------------------------------
# Full width: K4 against auto
# ---------------------------------------------------------------------------

#: (arch, layers kept, batch, prompt, max_seq, memory frames or patches):
#: each served config at full width, llama3-405b cut to 8 of its 126 layers
#: (59 GB) and llama-3.2-vision to 20 of its 100 (16 self, 4 cross; 38.5 GB)
#: to fit the card; prompts and max_seq put every K4 launch on a case of
#: ``ATTN_CASES``
FULL_WIDTH = [("recurrentgemma_9b", None, 1, 4096, 4224, None),
              ("olmoe_1b_7b", None, 1, 2048, 2052, None),
              ("granite_moe_3b_a800m", None, 1, 2048, 2112, None),
              ("qwen3_14b", None, 1, 4096, 4224, None),
              ("qwen1_5_4b", None, 1, 2048, 2052, None),
              ("starcoder2_15b", None, 1, 2048, 2064, None),
              ("llama3_405b", 8, 1, 2048, 2064, None),
              ("whisper_small", None, 4, 4, 448, 1500),
              ("whisper_small", None, 4, 224, 448, 1500),
              ("llama3_2_vision_90b", 20, 2, 2048, 2112, 1600)]
FULL_WIDTH_DECODE = 8


@pytest.mark.parametrize("arch,n_layers,b,s,max_seq,t_mem", FULL_WIDTH,
                         ids=[f"{c[0]}-{c[3]}" for c in FULL_WIDTH])
def test_full_width_prefill_through_k4_is_auto(card, arch, n_layers, b, s,
                                               max_seq, t_mem):
    """Params drawn on the card from one seed (the cross-attention
    families' zeros leaves live), seeded prompts and memory: one prefill of
    ``b`` rows through K4 and one through ``auto``, each followed by greedy
    decode steps.  K4 launches once an attention layer in the K4 prefill,
    at shapes ``ATTN_CASES`` holds, and nowhere else, each launch within
    K4's tolerances of the plain version on its served inputs; logits are
    finite; where auto's top-1 margin exceeds twice a row's largest gap
    between the two prefills' logits, its first token is auto's (MoE
    routing parts on near-ties, so later tokens may part)."""
    cfg = get(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    model = Model(cfg)
    params = model.init(0, device=card)
    rng = np.random.default_rng(FULL_WIDTH.index((arch, n_layers, b, s,
                                                  max_seq, t_mem)))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(card)
    memory = None
    if t_mem:
        live_params(cfg, params, seed=7)
        memory = torch.from_numpy(rng.standard_normal(
            (b, t_mem, cfg.d_model)).astype(np.float32)).to(card)
    first, missed = {}, []
    launch = k4_ops.mha_cuda

    def checked(q, k, v, **kw):
        out = launch(q, k, v, **kw)
        if not held_to_plain(out, k4_ref.mha_reference(q, k, v, **kw)):
            missed.append((tuple(q.shape), tuple(k.shape), kw))
        return out

    for impl in ("pallas", "auto"):
        k4.LAUNCHES["flash_attention"] = 0
        k4.SHAPES.clear()
        k4_ops.mha_cuda = checked
        try:
            logits, cache, cross = model.prefill(
                params, toks, memory=memory, impl=impl, max_seq=max_seq)
        finally:
            k4_ops.mha_cuda = launch
        assert not missed, f"K4 off its plain version on served inputs: {missed}"
        n_prefill = k4.LAUNCHES["flash_attention"]
        assert n_prefill == (k4_per_prefill(cfg) if impl == "pallas" else 0)
        assert set(k4.SHAPES) <= set(ATTN_CASES), "K4 at a shape no case holds"
        first[impl] = logits[:, :cfg.vocab_size].float()
        for i in range(FULL_WIDTH_DECODE):
            assert torch.isfinite(logits).all()
            tok = logits[:, :cfg.vocab_size].argmax(-1)
            logits, cache = model.decode_step(params, tok, s + i, cache,
                                              cross_stack=cross)
        assert torch.isfinite(logits).all()
        assert k4.LAUNCHES["flash_attention"] == n_prefill
        del logits, cache, cross
    gap = (first["pallas"] - first["auto"]).abs().amax(-1)
    top2 = first["auto"].topk(2, dim=-1).values
    gated = top2[:, 0] - top2[:, 1] > 2 * gap
    assert torch.equal(first["pallas"].argmax(-1)[gated],
                       first["auto"].argmax(-1)[gated])


# ---------------------------------------------------------------------------
# Sharding rules on the card
# ---------------------------------------------------------------------------

SHARD_PROMPT, SHARD_DECODE = 2048, 4


def flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    return [tree]


@pytest.mark.parametrize("arch", ["qwen1_5_4b", "olmoe_1b_7b"])
def test_sharding_rules_change_no_bit(card, arch):
    """The dry run's rules on a (data=2, model=2) mesh of four virtual
    shards of the card: qwen1.5-4b takes attention's Ulysses (headdim)
    branch, olmoe the heads and the expert-sharded MoE.  A 2048-token
    prefill through K4 and 4 decode steps, with the rules and without."""
    cfg = get(arch)
    mesh = Mesh((card,) * 4, ("data", "model"), (2, 2))
    rules = build_rules(cfg, info(arch), Shape("prefill_2k", "prefill",
                                               SHARD_PROMPT, 1),
                        mesh, multi_pod=False)
    model = Model(cfg)
    params = model.init(0, device=card)
    specs = resolve_param_specs(model.specs(), rules)
    split = [(dim, leaf.shape) for spec, leaf in zip(flat(specs), flat(params))
             for dim, entry in zip(leaf.shape, spec)
             if entry is not None and "model" in entry]
    assert split and all(d % cfg.model_axis_size == 0 for d, _ in split)
    toks = torch.from_numpy(np.random.default_rng(110).integers(
        0, cfg.vocab_size, (1, SHARD_PROMPT))).to(card)
    runs = []
    for r in (None, rules):
        k4.LAUNCHES["flash_attention"] = 0
        k4.SHAPES.clear()
        logits, cache, _ = model.prefill(params, toks, rules=r, impl="pallas",
                                         max_seq=SHARD_PROMPT + SHARD_DECODE)
        assert k4.LAUNCHES["flash_attention"] == cfg.n_layers
        assert set(k4.SHAPES) <= set(ATTN_CASES), "K4 at a shape no case holds"
        steps = [logits]
        for i in range(SHARD_DECODE):
            logits, cache = model.decode_step(params, steps[-1].argmax(-1),
                                              SHARD_PROMPT + i, cache, rules=r)
            steps.append(logits)
        assert k4.LAUNCHES["flash_attention"] == cfg.n_layers
        runs.append(steps + flat(cache))
    assert all(torch.isfinite(x).all() for x in runs[0][:SHARD_DECODE + 1])
    assert len(runs[0]) == len(runs[1])
    for a, b in zip(*runs):
        assert torch.equal(bits(a), bits(b))


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------

def test_serve_auction_prints_the_host_line(card):
    lines = [printed(serve_auction.main, ["--json", "--t-end", "60",
                                          "--device", d]) for d in ("cuda", "cpu")]
    assert [rc for rc, _ in lines] == [0, 0]
    assert lines[0][1].strip() and lines[0][1] == lines[1][1]


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "whisper_small"])
def test_train_launcher_on_the_card_is_the_host_run(card, arch):
    """``python -m repro_torch.launch.train --reduced --steps 20`` on cuda
    and on cpu: the losses agree within 1e-4, relative."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    losses = []
    for device in ("cuda", "cpu"):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
             "--reduced", "--steps", "20", "--device", device],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = next(x for x in proc.stdout.splitlines()
                    if x.startswith("losses: "))
        losses.append(json.loads(line[len("losses: "):]))
    assert len(losses[0]) == len(losses[1]) == 20
    assert all(abs(x - y) <= 1e-4 * abs(y) for x, y in zip(*losses))


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "olmoe_1b_7b"])
def test_serve_launcher_at_full_width(card, arch):
    """8 requests through K4, every one finished, K4 only at shapes
    ``ATTN_CASES`` holds."""
    k4.LAUNCHES["flash_attention"] = 0
    k4.SHAPES.clear()
    rc, out = printed(serve.main, ["--arch", arch, "--attn-impl", "pallas",
                                   "--json"])
    assert rc == 0 and json.loads(out.splitlines()[-1])["unfinished"] == []
    assert k4.LAUNCHES["flash_attention"] == k4_per_prefill(get(arch)) * 8
    assert set(k4.SHAPES) <= set(ATTN_CASES), "K4 at a shape no case holds"


# ---------------------------------------------------------------------------
# The examples
# ---------------------------------------------------------------------------

def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are no package)."""
    spec = importlib.util.spec_from_file_location(
        f"_card_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


STUDY_T_END = 300.0
STUDY = [("run", dict(title="steady state (heterogeneous MIG pool)",
                      t_end=STUDY_T_END)),
         ("run", dict(title="with slice failures (MTBF ~5.5 min, repair 50 s)",
                      t_end=1.5 * STUDY_T_END, failure_rate=0.003)),
         ("run_presets", dict(t_end=STUDY_T_END)),
         ("run_strategies", dict(t_end=STUDY_T_END))]


@pytest.mark.parametrize("fn,kw", STUDY, ids=["steady", "failures", "presets",
                                               "strategies"])
def test_cluster_study_tables_on_the_card_are_the_host_tables(card, fn, kw):
    """Each section of ``examples/cluster_study_torch.py`` cut to t = 300
    (failures 450): JASDA through K1 and K2 on the card against the plain
    torch versions on the host.  Every JASDA simulation on the card launches
    both kernels, at pools of at least 256 rows and 8 windows; no baseline
    and no host run launches one."""
    study = load_example("cluster_study_torch")
    simulate = study.simulate

    def run(device, impl):
        sims = []

        def recorded(sched, agents, cfg):
            before = (k1.LAUNCHES["jasda_score"], k2.LAUNCHES["wis_batch"],
                      len(k1.SHAPES), len(k2.SHAPES))
            res = simulate(sched, agents, cfg)
            health = getattr(sched, "backend_health", None)
            assert health is None or not health.failed_backends()
            sims.append((health is not None,
                         k1.LAUNCHES["jasda_score"] - before[0],
                         k2.LAUNCHES["wis_batch"] - before[1]))
            return res

        k1.SHAPES.clear()
        k2.SHAPES.clear()
        study.simulate = recorded
        try:
            _, text = printed(getattr(study, fn), device=device, impl=impl, **kw)
        finally:
            study.simulate = simulate
        return text, sims

    text, sims = run(card, "cuda")
    assert min(key[0] for key in k1.SHAPES) >= 256
    assert min(key[0] for key in k2.SHAPES) >= 8
    host_text, host_sims = run("cpu", "torch")
    assert text == host_text
    assert any(jasda for jasda, _, _ in sims)
    for jasda, n1, n2 in sims:
        assert (n1 > 0 and n2 > 0) if jasda else n1 == n2 == 0
    assert not any(n1 or n2 for _, n1, n2 in host_sims)


def test_serve_example_through_k4_is_auto(card):
    """``examples/serve_batch_torch.py`` through K4 and through auto: the
    same picks, but at a near-tie (auto's top-1 margin at most twice the
    runs' logit gap); K4 once a layer a prefill, 40 launches in all, none
    in decode or through auto; K4 within 7.2e-7 of its plain version on the
    served inputs."""
    ex = load_example("serve_batch_torch")
    n_layers = ex.build_model().n_layers
    Engine = ex.ServingEngine
    runs = {}
    for impl in ("pallas", "auto"):
        rec = {"prefill": [], "decode": [], "picks": []}

        class Recording(Engine):
            def _prefill(self, tokens):
                before = k4.LAUNCHES["flash_attention"]
                out = super()._prefill(tokens)
                rec["prefill"].append(k4.LAUNCHES["flash_attention"] - before)
                return out

            def _decode(self, tok, idx):
                before = k4.LAUNCHES["flash_attention"]
                out = super()._decode(tok, idx)
                rec["decode"].append(k4.LAUNCHES["flash_attention"] - before)
                return out

            def _pick(self, logits):
                rec["picks"].append(logits.copy())
                return super()._pick(logits)

        ex.ServingEngine = Recording
        try:
            (reqs, _, _), _ = printed(ex.main, ["--device", "cuda",
                                                "--attn-impl", impl])
        finally:
            ex.ServingEngine = Engine
        assert all(r.done for r in reqs) and not any(rec["decode"])
        runs[impl] = rec
    assert set(runs["pallas"]["prefill"]) == {n_layers}
    assert sum(runs["pallas"]["prefill"]) == 40
    assert not any(runs["auto"]["prefill"])
    for a, b in zip(runs["pallas"]["picks"], runs["auto"]["picks"]):
        if int(np.argmax(a)) != int(np.argmax(b)):
            top2 = np.sort(b)[-2:]
            assert top2[1] - top2[0] <= 2 * np.abs(a - b).max()
            break

    worst = [0.0]
    launch = k4_ops.mha_cuda

    def checked(q, k, v, **kw):
        out = launch(q, k, v, **kw)
        worst[0] = max(worst[0], float(
            (out - k4_ref.mha_reference(q, k, v, **kw)).abs().max()))
        return out

    k4_ops.mha_cuda = checked
    try:
        printed(ex.main, ["--device", "cuda", "--attn-impl", "pallas"])
    finally:
        k4_ops.mha_cuda = launch
    assert worst[0] <= 7.2e-7


def test_train_example_resumes_bit_for_bit(card, tmp_path):
    """``examples/train_100m_torch.py`` at full width: 40 steps into a new
    directory, then a second run on it to step 56.  The store gives back the
    first run's final state bit for bit, the second run starts from step
    40, and the loss falls in both."""
    ex = load_example("train_100m_torch")
    first, _ = printed(ex.main, ["--steps", "40", "--ckpt-dir", str(tmp_path)])
    assert first["start"] == 0 and first["job"].steps_done == 40
    losses = [first["losses"]]
    template = {"params": first["state"]["params"], "opt": first["state"]["opt"]}
    restored, step = first["store"].restore(template)
    saved, back = tree_flatten(template)[0], tree_flatten(restored)[0]
    assert step == 40 and len(saved) == len(back)
    for a, b in zip(saved, back):
        assert a.device == b.device and torch.equal(bits(a), bits(b))
    del first, template, restored, saved, back
    second, text = printed(ex.main, ["--steps", "56", "--ckpt-dir",
                                     str(tmp_path)])
    assert "resumed from checkpoint step 40" in text
    assert second["start"] == 40 and second["job"].steps_done == 16
    for run in losses + [second["losses"]]:
        assert all(math.isfinite(x) for x in run) and run[-1] < run[0]

"""The serving engine's decode step as one CUDA graph.

On the card the engine captures its first decode step and replays it on
every later step; each replay must give the logits and the cache that the
same engine gives when it launches every step eagerly, bit for bit, over
a run whose slots sit at different depths and are re-prefilled while the
graph is live.  Off the card, and in the families outside
``GRAPH_FAMILIES``, the step stays eager.  The card tests skip without a
CUDA card (``tests/torch_card.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced
from repro_torch.models import Model, ssm
from repro_torch.models.params import PORTED_FAMILIES
from repro_torch.runtime import trace
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.serving.engine import GRAPH_FAMILIES
from torch_card import card  # noqa: F401  (the fixture)

#: one served arch of each family the engine captures, at the dtype it is
#: served in where the reduced config allows (bf16 mamba, bf16 linear cache),
#: and jamba's hybrid (mamba, RoPE-free attention on a linear cache, the
#: dropless MoE's static decode)
ARCHS = [("falcon_mamba_7b", torch.bfloat16), ("qwen1_5_4b", torch.bfloat16),
         ("olmoe_1b_7b", torch.float32), ("recurrentgemma_9b", torch.float32),
         ("jamba2_mini", torch.bfloat16)]
#: (prompt length, new tokens): 3 slots at different depths; the second
#: request ends early and the fourth and fifth are prefilled into freed
#: slots while the graph is live; past the hybrid's 16-token window and
#: jamba's mixer chunk, cut to 16 tokens here (``mixer_chunk``)
SIZES = [(9, 24), (23, 5), (4, 30), (17, 12), (31, 14)]
SLOTS, MAX_SEQ = 3, 64


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(autouse=True)
def mixer_chunk(request, monkeypatch):
    """jamba's prompts run the chunked prefill: its mixer's chunks of 16
    tokens (2048 at the served size)."""
    spec = getattr(request.node, "callspec", None)
    if spec is not None and spec.params.get("arch") == "jamba2_mini":
        monkeypatch.setattr(ssm, "CHUNK", 16)


@pytest.fixture(autouse=True)
def few_threads():
    """Two of the host's threads: the suite runs on several workers at
    once, and a reduced model's small ops lose more to idle pool threads
    than they gain."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _eager(engine):
    """``engine`` made to launch every decode step itself."""
    engine._graphed = False
    return engine


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _served(arch, dtype, device):
    """The reduced ``arch`` at ``dtype``, its params drawn on the host."""
    cfg = reduced(arch).replace(dtype=dtype)
    model = Model(cfg)
    return model, _to(model.init(0, device="cpu"), device), cfg


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _requests(cfg, tag):
    rng = np.random.default_rng(7)
    return [Request(f"{tag}{i}", rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=new) for i, (n, new) in enumerate(SIZES)]


class _Log:
    """Each decode step's logits (copied: a replay overwrites the graph's
    output) and how the step ran, and the step of each prefill."""

    def __init__(self, engine):
        self.steps, self.prefills, self.engine = [], [], engine
        decode, prefill = engine._decode_slots, engine._prefill_into_slot

        def decode_slots():
            logits, how = decode()
            self.steps.append((logits.float().cpu(), how))
            return logits, how

        def prefill_into_slot(b, req):
            self.prefills.append(len(self.steps))
            prefill(b, req)

        engine._decode_slots = decode_slots
        engine._prefill_into_slot = prefill_into_slot


def test_only_the_cross_attention_families_stay_eager():
    assert GRAPH_FAMILIES <= set(PORTED_FAMILIES)
    assert set(PORTED_FAMILIES) - GRAPH_FAMILIES == {"vlm", "encdec"}


@pytest.mark.parametrize("arch,dtype", ARCHS, ids=[a for a, _ in ARCHS])
def test_every_step_is_eager_on_the_cpu(arch, dtype):
    model, params, cfg = _served(arch, dtype, torch.device("cpu"))
    eng = ServingEngine(model, params, ServeConfig(batch_slots=SLOTS,
                                                   max_seq=MAX_SEQ),
                        device="cpu")
    reqs = _requests(cfg, "r")
    with trace.enable():
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
    decode = trace.spans("engine.decode")
    assert decode and {s.attrs["graph"] for s in decode} == {"eager"}
    assert eng._graph is None and all(r.done for r in reqs)


@pytest.mark.card
@pytest.mark.parametrize("arch,dtype", ARCHS, ids=[a for a, _ in ARCHS])
def test_replays_match_the_eager_steps_bit_for_bit(card, arch, dtype):
    model, params, cfg = _served(arch, dtype, card)
    serve = ServeConfig(batch_slots=SLOTS, max_seq=MAX_SEQ)
    graph = ServingEngine(model, params, serve, device=card)
    eager = _eager(ServingEngine(model, params, serve, device=card))
    logs = [_Log(graph), _Log(eager)]
    reqs = [_requests(cfg, "g"), _requests(cfg, "e")]
    for eng, rs in zip((graph, eager), reqs):
        for r in rs:
            eng.submit(r)
    while True:
        with trace.enable():
            n = graph.step()
        assert eager.step() == n
        (a, how_a), (b, how_b) = logs[0].steps[-1], logs[1].steps[-1]
        assert torch.equal(a, b), (len(logs[0].steps), how_a)
        for x, y in zip(_leaves(graph.cache), _leaves(eager.cache)):
            assert torch.equal(x, y), len(logs[0].steps)
        if n == 0 and not graph.queue:
            break
    steps = len(logs[0].steps)
    assert steps >= 20
    assert [how for _, how in logs[0].steps] == ["capture"] + ["replay"] * (steps - 1)
    assert {how for _, how in logs[1].steps} == {"eager"}
    assert [s.attrs["graph"] for s in trace.spans("engine.decode")] == \
        ["capture"] + ["replay"] * (steps - 1)
    # requests prefilled into freed slots while the graph was live
    assert logs[0].prefills == logs[1].prefills
    assert sum(1 for at in logs[0].prefills if at >= 1) >= 2
    for a, b in zip(*reqs):
        assert a.done and a.output == b.output


@pytest.mark.card
@pytest.mark.parametrize("arch", ["llama3_2_vision_90b", "whisper_small"])
def test_cross_attention_families_stay_eager_on_the_card(card, arch):
    model = Model(reduced(arch))
    eng = ServingEngine(model, model.init(0, device=card),
                        ServeConfig(batch_slots=2, max_seq=32), device=card)
    assert model.cfg.family not in GRAPH_FAMILIES and not eng._graphed

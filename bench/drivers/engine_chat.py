"""A closed loop of chat clients on the serving engine.

``ServingEngine`` serves the configuration's model with ``slots`` batch
slots and greedy decoding to ``clients`` clients, each of which sends its
next request when its last one completes.  A request's prompt length is
log-uniform over ``prompt_range`` tokens and its output length uniform
over ``output_range`` (no end-of-sequence token): a pool of sizes drawn
from the cell's ``pool_seed``, sent in the order the seed permutes it.
Its token ids are uniform over the vocabulary, drawn from the seed.

Set-up draws the weights on the card, runs one prefill at the longest
prompt and the loop itself for ``warmup_steps`` engine steps (every slot
busy, the clients out of step; a count of steps, so that the window opens
at the same point of the seed's requests however fast the host is); then
the window opens and runs the same loop for ``--seconds`` seconds.  A
``window_steps`` parameter, which only the tests' CPU sizes set, closes it
after that many engine steps instead, so that the requests it finishes do
not depend on the host's speed.

End to end: ``serve_tokens_per_s``, the output tokens produced in the
window over the window.
"""
from __future__ import annotations

import gc
import time

import numpy as np

from bench import weights
from bench.counts import model as model_counts
from bench.drivers.executor_train import model_config, ref_cfg
from bench.reference import mamba as ref


class Clients:
    """The requests the clients send, in the order they send them."""

    def __init__(self, p: dict, vocab: int, seed: int):
        self.vocab = vocab
        rng = np.random.default_rng(p["pool_seed"])
        lo, hi = p["prompt_range"]
        n = p["pool_size"]
        prompts = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), n)).astype(int)
        outs = rng.integers(p["output_range"][0], p["output_range"][1] + 1, n)
        order = np.random.default_rng([seed, 5]).permutation(n)
        self.sizes = [(int(min(max(prompts[i], lo), hi)), int(outs[i]))
                      for i in order]
        self.rng = np.random.default_rng([seed, 6])
        self.sent = 0

    def next(self, client: int):
        n, out = self.sizes[self.sent % len(self.sizes)]
        prompt = self.rng.integers(0, self.vocab, n, dtype=np.int32)
        self.sent += 1
        return f"c{client}-{self.sent}", prompt, out


def run(h) -> dict:
    import torch
    from repro_torch.models import Model
    from repro_torch.serving.engine import Request, ServeConfig, ServingEngine

    ref.no_tf32()
    p, dev = h.params, h.device
    c, cfg = model_config(h)
    model = Model(cfg)
    meta = weights.meta_tree(c)
    if not weights.same_layout(meta, model.init(device="meta")):
        raise ValueError("the program's weights differ from the configuration's")
    params = weights.draw(meta, c, h.seed, dev)
    engine = ServingEngine(model, params, ServeConfig(
        batch_slots=p["slots"], max_seq=p["max_seq"], greedy=True), device=dev)
    clients = Clients(p, c["vocab"], h.seed)
    log = {"requests": {}, "live": set(), "prefill_tokens": 0, "steps": 0,
           "ttft": []}

    def submit(client: int) -> None:
        rid, prompt, out = clients.next(client)
        req = Request(rid, prompt, max_new_tokens=out)
        req.client, req.t_submit = client, time.perf_counter()
        log["requests"][rid] = req
        log["live"].add(rid)
        engine.submit(req)

    prefill = engine._prefill_into_slot

    def timed_prefill(b, req):
        with h.span("prefill"):
            prefill(b, req)
        if h.window_open:
            log["prefill_tokens"] += len(req.prompt)
            if req.t_submit >= h.t_open:
                log["ttft"].append(time.perf_counter() - req.t_submit)

    engine._prefill_into_slot = timed_prefill

    def step() -> None:
        with h.span("engine_step"):
            engine.step()
        if h.window_open:
            log["steps"] += 1
        for rid in [r for r in log["live"] if log["requests"][r].done]:
            log["live"].discard(rid)
            log["requests"][rid].t_done = time.perf_counter()
            submit(log["requests"][rid].client)

    def produced() -> int:
        return sum(len(r.output) for r in log["requests"].values())

    # set-up: the longest prefill once, then the loop until it is steady
    h.warm_trace()
    with torch.no_grad():
        model.prefill(params, torch.zeros((1, p["prompt_range"][1]),
                                          dtype=torch.int32, device=dev),
                      max_seq=p["max_seq"])
    for client in range(p["clients"]):
        submit(client)
    for _ in range(p["warmup_steps"]):
        step()
    h.open_window()
    before = produced()
    h.start_trace()
    window_steps = p.get("window_steps")
    while (h.elapsed() < h.seconds if window_steps is None
           else log["steps"] < window_steps):
        step()
        if h.tracing and log["steps"] >= p["trace_steps"]:
            h.stop_trace()
    h.close_window()
    tokens = produced() - before
    h.read_peak()
    # the window's requests: sent after it opened, finished before it closed
    finished = [r for r in log["requests"].values()
                if r.done and h.t_open <= r.t_submit and r.t_done <= h.t_close]
    h.window_requests = finished
    served = [(r.prompt, list(r.output)) for r in finished]
    steps = log["steps"]
    prefill_s = sum(b - a for a, b in h.in_window("prefill"))
    step_s = sum(b - a for a, b in h.in_window("engine_step"))
    h.counters.update(
        steps=steps, tokens=tokens, ttft=log["ttft"],
        decode_s=step_s - prefill_s, requests=len(log["ttft"]),
        model_flops=model_counts.inference_flops(
            c, log["prefill_tokens"] + tokens))
    del engine, log
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    checks = check(h, c, params, served)
    return {"e2e": {"serve_tokens_per_s": h.counters["tokens"] / h.window_s},
            "attempted": len(finished), "failed": 0, "checks": checks}


def sample(h, served):
    """The requests the reference reads, of those the window sent and
    finished: the longest one and others drawn from the seed,
    ``check_requests`` in all."""
    if not served:
        return []
    order = sorted(range(len(served)),
                   key=lambda i: -(len(served[i][0]) + len(served[i][1])))
    rng = np.random.default_rng([h.seed, 9])
    rest = list(rng.permutation(order[1:]))
    return [served[i] for i in [order[0]] + rest[: h.params["check_requests"] - 1]]


def reference_logits(params, rows, c, low=None):
    """The reference's logits over each prompt and its served tokens (but
    the last), the rows padded on the right to one length.  The logits
    cover the padded vocabulary: the engine picks its greedy tokens over
    all of it."""
    import torch

    seqs = [np.concatenate([pr, np.asarray(out[:-1], np.int32)]) for pr, out in rows]
    width = max(len(s) for s in seqs)
    toks = np.zeros((len(seqs), width), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    dev = params["embed"].device
    with torch.no_grad():
        lg = ref.logits(params, torch.from_numpy(toks).to(dev), ref_cfg(c), low=low)
    return lg


def logit_gap(ref_lg, rows, picks=None) -> float:
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position (``picks``: other tokens to judge
    in the served tokens' place)."""
    worst = 0.0
    for i, (pr, out) in enumerate(rows):
        pos = np.arange(len(pr) - 1, len(pr) - 1 + len(out))
        lg = ref_lg[i, pos].double()
        tok = (np.asarray(out) if picks is None else picks[i])
        got = lg[np.arange(len(out)), tok]
        worst = max(worst, float((lg.max(dim=1).values - got).max()))
    return worst


def check(h, c, params, served) -> dict:
    t0 = time.perf_counter()
    rows = sample(h, served)
    lg = reference_logits(params, rows, c) if rows else None
    h.reference = (params, rows, lg)
    h.counters["reference_s"] = time.perf_counter() - t0
    h.counters["checked_tokens"] = sum(len(out) for _, out in rows)
    gap = logit_gap(lg, rows) if rows else 0.0
    # a run that finished no request to check is not correct
    return {"logit_gap": {"value": gap, "limit": h.limits["logit_gap"]},
            "requests_unchecked": {"value": int(not rows), "limit": 0}}


def control(h) -> dict:
    """The reference in the program's place, its matmul operands rounded
    to float8 e4m3 (below the configuration's bfloat16): at each served
    position, the token it ranks first, judged by the float32 reference."""
    import torch

    params, rows, lg = h.reference
    c, _ = model_config(h)
    low = reference_logits(params, rows, c, low=torch.float8_e4m3fn)
    picks = []
    for i, (pr, out) in enumerate(rows):
        pos = np.arange(len(pr) - 1, len(pr) - 1 + len(out))
        picks.append(low[i, pos].argmax(dim=1).cpu().numpy())
    return {"logit_gap": logit_gap(lg, rows, picks)}

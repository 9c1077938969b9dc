"""Long-document clients on the serving engine: jamba at one card's share.

``ServingEngine`` serves AI21-Jamba2-Mini (this card's 8 of 16 experts a
MoE layer) with ``slots`` batch slots, greedy decoding and each prefill's
attention through the flash-attention kernel K4 (``attn_impl``), to
``clients`` closed-loop clients: a client sends its next request when its
last one completes.  The requests are ``engine_chat``'s: prompt lengths
log-uniform over ``prompt_range``, output lengths uniform over
``output_range``, from the cell's pool in the seed's order, token ids
uniform over the vocabulary.

Set-up draws the weights on the card from the seed, runs one prefill at
the longest prompt and the loop for ``warmup_steps`` engine steps; the
window then runs the loop for ``--seconds`` seconds (``window_steps``,
which only the tests' CPU sizes set, closes it after that many steps).  A
traced run's stretch is the window's first ``trace_steps`` steps, and more
until one of them has prefilled a request.  At the stretch's two ends the
driver reads the program's count of routed choices per expert
(``Model.routed_choices``); after the window it sums, from the stretch's
profile, the device time of the activities launched inside the program's
``model.moe`` ranges, and counts its ``engine.prefill`` ranges
(:func:`moe_device_s`).

End to end: ``serve_tokens_per_s``, the output tokens produced in the
window over the window.  ``correct``: as ``engine_chat``'s, the reference
(``bench/reference/jamba.py``, float32, one sequence at a time in blocks)
reads the window's longest finished request and others drawn from the
seed; each served token's gap, by how much its reference logit lies below
the reference's best there, is held to the limits by the widest gap and by
the mean gap of the checked tokens.
"""
from __future__ import annotations

import bisect
import gc
import time

import numpy as np
import torch

from bench import weights
from bench.counts import jamba as counts
from bench.drivers.engine_chat import Clients, sample
from bench.reference import jamba as ref
from bench.reference.mamba import no_tf32

#: catalog keys the program computes as published, and their values
AS_PUBLISHED = {"hidden_act": "silu", "mamba_conv_bias": True,
                "mamba_proj_bias": False, "sliding_window": None,
                "tie_word_embeddings": False, "model_type": "jamba"}


def block(mixer: str, ffn: str) -> str:
    """The program's block kind of a layer of ``mixer`` and ``ffn``."""
    if mixer == "attn":
        return "attn" if ffn == "mlp" else "moe"
    return f"mamba_{ffn}"


def model_config(h):
    """The bench's configuration (with any test overrides) and the
    program's ``ModelConfig`` built from it, checked against each other.
    The program's registry names the model first: a program without it
    fails here, before any weight is drawn."""
    from repro_torch.configs import get

    c = dict(h.config)
    c.update(h.params.get("config_overrides", {}))
    base = get("jamba2_mini")
    cfg = base.replace(
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        head_dim=c["head_dim"], d_ff=c["intermediate_size"],
        d_expert=c["intermediate_size"], vocab_size=c["vocab_size"],
        n_experts=c["num_experts"], top_k=c["num_experts_per_tok"],
        held_experts=(c["expert_first"], c["experts"]),
        ssm_state=c["mamba_d_state"], ssm_conv=c["mamba_d_conv"],
        ssm_expand=c["mamba_expand"], dt_rank=c["mamba_dt_rank"],
        norm_eps=c["rms_norm_eps"], dtype=getattr(torch, c["dtype"]))
    want = [block(m, f) for m, f in counts.kinds(c)]
    derived = {"d_inner": cfg.d_inner, "padded_vocab": cfg.padded_vocab}
    if (any(c[k] != v for k, v in derived.items()) or list(cfg.layer_kinds) != want
            or any(c[k] != v for k, v in AS_PUBLISHED.items())
            or not (cfg.mamba_norms and not cfg.use_rope
                    and cfg.moe_routing == "dropless")):
        raise ValueError("the program's jamba differs from the configuration")
    c["init"] = {k: [r[0]] + [c.get(x, x) if isinstance(x, str) else x
                              for x in r[1:]]
                 for k, r in c["init"].items()}
    return c, cfg


def shapes(c: dict) -> dict:
    """The weight tree the configuration states, as ``(shape, dtype name)``
    leaves: embedding, unembedding, final norm, and per position j of the
    8-layer period a stack of its layers (norms, mixer, FFN)."""
    big, f32 = c["dtype"], "float32"
    D, F, V = c["hidden_size"], c["intermediate_size"], c["padded_vocab"]
    Dm, N, K, R = c["d_inner"], c["mamba_d_state"], c["mamba_d_conv"], c["mamba_dt_rank"]
    H, Hkv, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    E, held = c["num_experts"], c["experts"]
    period = c["attn_layer_period"]
    L = c["num_hidden_layers"] // period
    mamba = {"in_proj": ((L, D, 2, Dm), big), "conv_w": ((L, K, Dm), big),
             "conv_b": ((L, Dm), big), "x_proj": ((L, Dm, R + 2 * N), big),
             "dt_proj": ((L, R, Dm), big), "dt_bias": ((L, Dm), f32),
             "a_log": ((L, Dm, N), f32), "d_skip": ((L, Dm), f32),
             "out_proj": ((L, Dm, D), big), "dt_norm": ((L, R), f32),
             "b_norm": ((L, N), f32), "c_norm": ((L, N), f32)}
    attn = {"wq": ((L, D, H, hd), big), "wk": ((L, D, Hkv, hd), big),
            "wv": ((L, D, Hkv, hd), big), "wo": ((L, H, hd, D), big)}
    mlp = {"w_up": ((L, D, F), big), "w_down": ((L, F, D), big),
           "w_gate": ((L, D, F), big)}
    moe = {"router": ((L, D, E), f32), "w_gate": ((L, held, D, F), big),
           "w_up": ((L, held, D, F), big), "w_down": ((L, held, F, D), big)}
    blocks = {}
    for j, (mixer, ffn) in enumerate(counts.kinds(c)[:period]):
        blocks[f"b{j}_{block(mixer, ffn)}"] = {
            "ln1_scale": ((L, D), f32), "ln2_scale": ((L, D), f32),
            mixer: attn if mixer == "attn" else mamba,
            ffn: moe if ffn == "moe" else mlp}
    return {"embed": ((V, D), big), "unembed": ((D, V), big),
            "final_norm": ((D,), f32), "blocks": blocks}


def meta_tree(c: dict) -> dict:
    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        shape, dt = t
        return torch.empty(shape, dtype=getattr(torch, dt), device="meta")
    return build(shapes(c))


def ref_layout(params, c: dict) -> dict:
    """The program's stacked tree as the reference's list of layers
    (views, nothing copied but the norms' ``1 + scale``)."""
    period = c["attn_layer_period"]
    layers = []
    for i, (mixer, ffn) in enumerate(counts.kinds(c)):
        j, s = i % period, i // period
        blk = params["blocks"][f"b{j}_{block(mixer, ffn)}"]
        p = {"ln1": 1 + blk["ln1_scale"][s], "ln2": 1 + blk["ln2_scale"][s]}
        if mixer == "attn":
            a = {k: v[s] for k, v in blk["attn"].items()}
            d = a["wq"].shape[0]
            p.update(wq=a["wq"].reshape(d, -1), wk=a["wk"].reshape(d, -1),
                     wv=a["wv"].reshape(d, -1), wo=a["wo"].reshape(-1, d))
        else:
            m = {k: v[s] for k, v in blk["mamba"].items()}
            p.update(in_proj=m["in_proj"].reshape(m["in_proj"].shape[0], -1),
                     conv_w=m["conv_w"], conv_b=m["conv_b"], x_proj=m["x_proj"],
                     dt_proj=m["dt_proj"], dt_bias=m["dt_bias"], A_log=m["a_log"],
                     D=m["d_skip"], out_proj=m["out_proj"],
                     dt_norm=1 + m["dt_norm"], b_norm=1 + m["b_norm"],
                     c_norm=1 + m["c_norm"])
        p.update({k: v[s] for k, v in blk[ffn].items()})
        layers.append(p)
    return {"embed": params["embed"], "unembed": params["unembed"],
            "final_norm": 1 + params["final_norm"], "layers": layers}


def ref_cfg(c: dict) -> dict:
    return {"norm_eps": c["rms_norm_eps"], "n_heads": c["num_attention_heads"],
            "n_kv_heads": c["num_key_value_heads"], "head_dim": c["head_dim"],
            "conv": c["mamba_d_conv"], "state": c["mamba_d_state"],
            "dt_rank": c["mamba_dt_rank"], "top_k": c["num_experts_per_tok"],
            "held": (c["expert_first"], c["experts"]),
            **{k: c[k] for k in ("attn_layer_period", "attn_layer_offset",
                                 "expert_layer_period", "expert_layer_offset")}}


def run(h) -> dict:
    from repro_torch.models import Model
    from repro_torch.serving.engine import Request, ServeConfig, ServingEngine

    no_tf32()
    p, dev = h.params, h.device
    c, cfg = model_config(h)
    model = Model(cfg)
    meta = meta_tree(c)
    if not weights.same_layout(meta, model.init(device="meta")):
        raise ValueError("the program's weights differ from the configuration's")
    params = weights.draw(meta, c, h.seed, dev)
    engine = ServingEngine(model, params, ServeConfig(
        batch_slots=p["slots"], max_seq=p["max_seq"], greedy=True), device=dev,
        attn_impl=p["attn_impl"])
    clients = Clients(p, c["vocab_size"], h.seed)
    log = {"requests": {}, "live": set(), "prefill_tokens": 0, "steps": 0,
           "ttft": [], "stretch_prefills": 0}

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
            log["stretch_prefills"] += 1
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

    def routed():
        read = getattr(model, "routed_choices", None)
        n = None if read is None else read(dev)
        return None if n is None else n.cpu().numpy().astype(np.int64)

    # set-up: the longest prefill once, then the loop until it is steady
    h.warm_trace()
    with torch.no_grad():
        model.prefill(params, torch.zeros((1, p["prompt_range"][1]),
                                          dtype=torch.int32, device=dev),
                      impl=p["attn_impl"], max_seq=p["max_seq"])
    for client in range(p["clients"]):
        submit(client)
    for _ in range(p["warmup_steps"]):
        step()
    h.open_window()
    before = produced()
    stretch = [routed()] if h.trace else None
    log["stretch_prefills"] = 0
    h.start_trace()
    prof = getattr(h, "_prof", None)  # the stretch's profile, read after
    window_steps = p.get("window_steps")
    while (h.elapsed() < h.seconds if window_steps is None
           else log["steps"] < window_steps):
        step()
        if (stretch is not None and len(stretch) == 1
                and log["steps"] >= p["trace_steps"] and log["stretch_prefills"]):
            h.stop_trace()
            stretch.append(routed())
            h.counters["stretch_prefills"] = log["stretch_prefills"]
    h.close_window()
    tokens = produced() - before
    if stretch is not None and len(stretch) == 1:  # the window ended first
        stretch.append(routed())
    if stretch is not None and stretch[0] is not None:
        h.counters["routed"] = (stretch[1] - stretch[0]).tolist()
        h.counters["held"] = [c["expert_first"], c["experts"]]
    if prof is not None and h.trace_data is not None:
        moe_s, prefills = moe_device_s(prof.profiler.kineto_results.events())
        h.counters.update(moe_prefill_device_s=moe_s, moe_prefills=prefills)
    del prof
    h.read_peak()
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
        model_flops=counts.inference_flops(c, log["prefill_tokens"] + tokens))
    del engine, log
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    checks = check(h, c, params, served)
    return {"e2e": {"serve_tokens_per_s": h.counters["tokens"] / h.window_s},
            "attempted": len(finished), "failed": 0, "checks": checks}


def moe_device_s(events):
    """From a profile's kineto events: the seconds of device activity
    launched inside the program's ``model.moe`` ranges (each activity
    belongs to the host op that launched it, the op to the range that holds
    its start), and the number of ``engine.prefill`` ranges."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges, ops, acts, prefills = [], {}, [], 0
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                acts.append((e.linked_correlation_id(), e.end_ns() - e.start_ns()))
            continue
        if e.name() == "model.moe":
            ranges.append((e.start_ns(), e.end_ns()))
        elif e.name() == "engine.prefill":
            prefills += 1
        if e.linked_correlation_id() == 0:  # a host op (a range is one too)
            ops[e.correlation_id()] = e.start_ns()
    ranges.sort()
    starts = [a for a, _ in ranges]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ranges[i][1]

    ns = sum(d for op, d in acts if op in ops and inside(ops[op]))
    return ns / 1e9, prefills


def reference_logits(params, rows, c, low=None):
    """Per row, the reference's (len(out), V) logits at the positions whose
    next token was served: over the prompt and the served tokens but the
    last."""
    layout, rc = ref_layout(params, c), ref_cfg(c)
    dev = params["embed"].device
    out = []
    with torch.no_grad():
        for pr, served in rows:
            seq = np.concatenate([pr, np.asarray(served[:-1], np.int32)])
            pos = np.arange(len(pr) - 1, len(seq))
            out.append(ref.logits_at(layout, torch.from_numpy(seq).to(dev), rc,
                                     pos, low=low).cpu())
    return out


def gaps(ref_lg, rows, picks=None) -> torch.Tensor:
    """Each checked token's gap: by how much its reference logit lies below
    the reference's best at its position (``picks``: other tokens to judge
    in the served tokens' place), all rows' in one float64 vector."""
    out = []
    for i, (pr, served) in enumerate(rows):
        lg = ref_lg[i].double()
        tok = torch.as_tensor(np.asarray(served if picks is None else picks[i]))
        out.append(lg.max(dim=1).values - lg[torch.arange(len(tok)), tok.long()])
    return torch.cat(out)


def judged(g: torch.Tensor) -> dict:
    """The check's numbers of the checked tokens' gaps: the widest, and the
    mean.  The program's bfloat16 tips some of the float32 router's
    near-ties to another expert, more of them the deeper the layer, and a
    few tokens a run read gaps far above the rest; the mean stays small
    unless most tokens move, as the control's do."""
    return {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean())}


def check(h, c, params, served) -> dict:
    t0 = time.perf_counter()
    rows = sample(h, served)
    lg = reference_logits(params, rows, c) if rows else None
    h.reference = (params, rows, lg)
    h.counters["reference_s"] = time.perf_counter() - t0
    h.counters["checked_tokens"] = sum(len(out) for _, out in rows)
    got = judged(gaps(lg, rows)) if rows else dict.fromkeys(
        ("logit_gap", "logit_gap_mean"), 0.0)
    # a run that finished no request to check is not correct
    return {**{k: {"value": v, "limit": h.limits[k]} for k, v in got.items()},
            "requests_unchecked": {"value": int(not rows), "limit": 0}}


def control(h) -> dict:
    """The reference in the program's place, its weights' products rounded
    to float8 e4m3 (below the configuration's bfloat16): at each served
    position, the token it ranks first, judged by the float32 reference."""
    params, rows, lg = h.reference
    c, _ = model_config(h)
    low = reference_logits(params, rows, c, low=torch.float8_e4m3fn)
    return judged(gaps(lg, rows, [x.argmax(dim=1) for x in low]))

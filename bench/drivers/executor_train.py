"""A training job atomised by the JASDA executor: the paper's integration.

One ``TrainingJob`` is registered with ``JasdaExecutor`` on one lane (the
card's memory), with far more steps than the window can run; its chunks
are bid into announced windows and each committed chunk runs real train
steps of the program's ``make_train_step`` (AdamW on a warm-up-cosine
rate, clip 1.0, remat) on batches of token ids drawn from the seed.  No
checkpoint is written.

Set-up draws the weights on the card, builds the step and its optimizer
state, and runs the first three steps through the same chunk call and
feed the executor uses: the reference follows those three.  The window
opens when the executor starts and closes after the first step that ends
``--seconds`` later.

End to end: ``train_tokens_per_s``, the tokens of every step completed in
the window over the window (the executor's rounds between chunks
included).
"""
from __future__ import annotations

import gc
import time

import numpy as np

from bench import weights
from bench.counts import model as model_counts
from bench.reference import mamba as ref


class _Stop(Exception):
    """Raised after a step to end the executor's run at the window's end."""


def model_config(h):
    """The bench's configuration (with any test overrides) and the
    program's ``ModelConfig`` built from it, checked against each other."""
    import torch
    from repro_torch.configs import get

    c = dict(h.config)
    c.update(h.params.get("config_overrides", {}))
    cfg = get("falcon_mamba_7b").replace(
        n_layers=c["layers"], d_model=c["d_model"], ssm_state=c["state"],
        ssm_conv=c["conv"], ssm_expand=c["expand"], vocab_size=c["vocab"],
        dtype=getattr(torch, c["dtype"]), norm_eps=c["norm_eps"])
    derived = {"d_inner": cfg.d_inner, "dt_rank": cfg.dt_rank_actual,
               "padded_vocab": cfg.padded_vocab}
    if any(c[k] != v for k, v in derived.items()):
        raise ValueError(f"the program derives {derived} from the configuration")
    c["init"] = {k: [r[0]] + [c.get(x, x) if isinstance(x, str) else x
                              for x in r[1:]]
                 for k, r in c["init"].items()}
    return c, cfg


def token_batch(c: dict, p: dict, seed: int, step: int, device) -> dict:
    """Step ``step``'s rows: token ids uniform over the vocabulary, drawn
    on the device from ``(seed, step)``; labels are the ids shifted by one."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(weights.leaf_seed(seed, 1_000_000 + step))
    x = torch.randint(0, c["vocab"], (p["batch"], p["seq"] + 1),
                      generator=gen, device=device, dtype=torch.int32)
    return {"tokens": x[:, :-1].contiguous(), "labels": x[:, 1:].contiguous()}


def _norms(tree) -> dict:
    import torch

    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in ref.leaves(tree).items()}


def run(h) -> dict:
    import torch
    from repro_torch.core import JasdaScheduler, Policy, SliceSpec
    from repro_torch.core.executor import JasdaExecutor, TrainingJob
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.core.windows import WindowPolicy
    from repro_torch.models import Model
    from repro_torch.training import adamw, make_train_step, warmup_cosine

    ref.no_tf32()
    p, dev = h.params, h.device
    c, cfg = model_config(h)
    o = p["optimizer"]
    model = Model(cfg)
    meta = weights.meta_tree(c)
    if not weights.same_layout(meta, model.init(device="meta")):
        raise ValueError("the program's weights differ from the configuration's")
    state = {"params": weights.draw(meta, c, h.seed, dev)}
    opt = adamw(warmup_cosine(o["peak_lr"], o["warmup"], o["total_steps"]),
                b1=o["b1"], b2=o["b2"], eps=o["eps"],
                weight_decay=o["weight_decay"])
    state["opt"] = opt.init(state["params"])
    step_fn = make_train_step(model, opt, remat=True, clip_norm=o["clip"])
    tokens = p["batch"] * p["seq"]
    log = {"loss": {}, "steps": 0}

    def run_steps(s0: int, n: int):
        loss = None
        for i in range(s0, s0 + n):
            with h.span("step"):
                batch = token_batch(c, p, h.seed, i, dev)
                state["params"], state["opt"], m = step_fn(
                    state["params"], state["opt"], batch, i)
                loss = float(m["loss"])
            log["loss"][i] = loss
            if h.window_open:
                log["steps"] += 1
                if h.tracing and log["steps"] >= p["trace_steps"]:
                    h.stop_trace()
                if h.elapsed() >= h.seconds:
                    h.close_window()
                    raise _Stop
        return {"loss": loss}

    # the first three steps, through the chunk call the window runs
    h.warm_trace()
    run_steps(0, 1)
    first = {k: v / (1.0 - o["b1"]) for k, v in _norms(state["opt"]["m"]).items()}
    run_steps(1, 2)
    names = weights.leaf_names(meta)
    change = {}
    for name, leaf in ref.leaves(state["params"]).items():
        p0 = weights.draw_leaf(name, leaf, names[name], c, h.seed, dev)
        change[name] = float(torch.linalg.vector_norm(leaf.float() - p0.float()))
        del p0
    lane = (torch.cuda.get_device_properties(dev).total_memory
            if dev == "cuda" else 80 * (1 << 30))
    sched = JasdaScheduler(
        [SliceSpec("lane0", lane, n_chips=1)],
        SchedulerConfig.from_policy(
            Policy(window=WindowPolicy(horizon=3600.0, min_gap=0.3)),
            device=dev))
    ex = JasdaExecutor(sched)
    n_params = model_counts.ssm_params(c)
    job = TrainingJob(
        job_id=c["name"], total_steps=o["total_steps"], step_fn=run_steps,
        param_bytes=n_params * 4.0, optimizer_bytes=n_params * 8.0,
        activation_bytes=tokens * c["d_model"] * 16.0, steps_per_sec=2.0,
        steps_done=3)
    ex.register(job)
    h.wrap(job, "step_fn", "chunk")

    h.open_window()
    h.start_trace()
    try:
        ex.run(max_wall=1e9)
    except _Stop:
        pass
    if h.window_open:
        raise RuntimeError("the executor stopped inside the window")
    h.read_peak()
    steps = log["steps"]
    h.counters.update(steps=steps, tokens=steps * tokens,
                      model_flops=model_counts.train_flops(c, steps * tokens))
    program = {"loss": [log["loss"][i] for i in range(3)],
               "first": first, "change": change}
    state.clear()
    del step_fn, opt, model, job, ex, sched
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    checks = check(h, c, p, program)
    return {"e2e": {"train_tokens_per_s": steps * tokens / h.window_s},
            "attempted": steps, "failed": 0, "checks": checks}


def reference_run(h, c, p, low=None):
    """The reference's three steps from the seed's weights and batches:
    (losses, first gradient's norms, change norms), by leaf."""
    import torch

    dev = h.device
    meta = weights.meta_tree(c)
    params = weights.draw(meta, c, h.seed, dev)
    batches = [token_batch(c, p, h.seed, i, dev) for i in range(3)]
    losses, first = ref.train(params, batches, ref_cfg(c), p["optimizer"], low=low)
    names = weights.leaf_names(meta)
    change = {}
    for name, leaf in ref.leaves(params).items():
        p0 = weights.draw_leaf(name, leaf, names[name], c, h.seed, dev)
        change[name] = float(torch.linalg.vector_norm(leaf.float() - p0.float()))
    del params
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"loss": losses, "first": first, "change": change}


def ref_cfg(c: dict) -> dict:
    return {k: c[k] for k in ("layers", "d_model", "d_inner", "state", "conv",
                              "dt_rank", "vocab", "norm_eps")}


def compare(got: dict, want: dict) -> dict:
    """The three numbers: the widest relative gap of the three losses; of
    the first gradient's norm by leaf; of the change's norm by leaf, over
    the leaves the reference's first gradient moves (norm at least a
    thousandth of the median leaf's).  A leaf's gap is taken against the
    larger of its reference norm and the median leaf's."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
    med_g = float(np.median(list(want["first"].values())))
    grad = max(abs(got["first"][k] - v) / max(v, med_g)
               for k, v in want["first"].items())
    moved = [k for k, v in want["first"].items() if v >= 1e-3 * med_g]
    med_c = float(np.median([want["change"][k] for k in moved]))
    change = max(abs(got["change"][k] - want["change"][k])
                 / max(want["change"][k], med_c) for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def check(h, c, p, program) -> dict:
    t0 = time.perf_counter()
    want = reference_run(h, c, p)
    h.reference = want
    h.program = program
    got = compare(program, want)
    h.counters["reference_s"] = time.perf_counter() - t0
    return {k: {"value": v, "limit": h.limits[k]} for k, v in got.items()}


def control(h) -> dict:
    """The reference in the program's place, its matmul operands rounded
    to float8 e4m3 (the precision below the configuration's bfloat16)."""
    import torch

    c, _ = model_config(h)
    low = reference_run(h, c, h.params, low=torch.float8_e4m3fn)
    return compare(low, h.reference)

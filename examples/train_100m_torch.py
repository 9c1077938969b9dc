"""End-to-end training on the PyTorch port: a ~100M-parameter dense LM for a
few hundred steps, run AS A JASDA JOB under the executor — atomized into
subjob chunks, each chunk bid into scheduler-announced windows, executed
for real, measured (feeding ex-post verification), and checkpointed at
chunk boundaries.

The same run as ``examples/train_100m.py``, through ``repro_torch``, on
``--device`` (the CUDA card by default, or ``cpu``).  Each train step
accumulates the gradient over 2 microbatches, and each chunk boundary saves
``{"params", "opt"}`` without blocking the next chunk: ``save`` copies the
tensors to the host before it returns and writes them in a thread.  Rerun
with the same ``--ckpt-dir`` to resume from its latest step.

Run: PYTHONPATH=src python examples/train_100m_torch.py --steps 300
(use --steps 20 for a quick smoke; --device cpu to train on the host)
"""
import argparse
import tempfile

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.checkpoint.store import tree_flatten
from repro_torch.core import JasdaScheduler, SliceSpec
from repro_torch.core.executor import JasdaExecutor, TrainingJob
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.windows import WindowPolicy
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.kernels.common import resolve_device
from repro_torch.models import Model, ModelConfig
from repro_torch.training import adamw, make_train_step, warmup_cosine

GB = 1 << 30


def build_model():
    """~100M params: 12L × d768 × 12H, 32k vocab (GPT-2-small class)."""
    return ModelConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=32768,
        model_axis_size=1, dtype=torch.float32)


def init_params(model, device):
    """The model's params, drawn from seed 0 on ``device``."""
    return model.init(0, device=device)


def main(argv=None):
    """Train, print the reference's lines, and return the run's record:
    losses, the job, the store, the final state, the step resumed from,
    and the train step and data it ran."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_model()
    model = Model(cfg)
    params = init_params(model, dev)
    n_params = sum(x.numel() for x in tree_flatten(params)[0])
    print(f"model: {cfg.name} {n_params/1e6:.1f}M params")

    opt = adamw(warmup_cosine(3e-4, 50, args.steps))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, microbatches=2)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch))
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="ckpt_100m_")
    store = CheckpointStore(ckpt_dir)
    state = {"params": params, "opt": opt_state}

    # auto-resume (fault tolerance: kill this script and rerun)
    start = 0
    if store.latest_step() is not None:
        state, start = store.restore(state)
        print(f"resumed from checkpoint step {start}")

    losses = []

    def run_steps(s0, n):
        loss = None
        for i in range(s0 + start, s0 + start + n):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch(i).items()}
            state["params"], state["opt"], m = step_fn(
                state["params"], state["opt"], batch, i)
            loss = float(m["loss"])
            losses.append(loss)
        return {"loss": loss}

    def checkpoint(steps_done):
        store.save(start + steps_done,
                   {"params": state["params"], "opt": state["opt"]},
                   blocking=False)

    # ---- run under JASDA ---------------------------------------------------
    sched = JasdaScheduler(
        [SliceSpec("lane0", 8 * GB, n_chips=1)],
        SchedulerConfig(window=WindowPolicy(horizon=600.0, min_gap=0.3),
                        device=dev.type))
    ex = JasdaExecutor(sched)
    job = TrainingJob(
        job_id=cfg.name, total_steps=args.steps - start, step_fn=run_steps,
        checkpoint_fn=checkpoint,
        param_bytes=n_params * 4.0, optimizer_bytes=n_params * 8.0,
        activation_bytes=args.batch * args.seq * cfg.d_model * 4.0 * 4,
        steps_per_sec=2.0)
    ex.register(job)
    ex.run(max_wall=3600.0)
    store.wait()

    print(f"\ndone: {job.steps_done} steps in {len(job.metrics_log)} JASDA chunks")
    print(f"loss: first={losses[0]:.3f} last={losses[-1]:.3f}")
    snap = sched.calibrator.snapshot()[cfg.name]
    print(f"job reliability after real measurements: rho={snap['rho']:.3f} "
          f"(verified chunks: {snap['n_verified']})")
    print(f"checkpoints in {ckpt_dir}: steps {store.steps()}")
    assert losses[-1] < losses[0], "training must reduce loss"
    return {"losses": losses, "job": job, "store": store, "state": state,
            "start": start, "n_params": n_params, "scheduler": sched,
            "step_fn": step_fn, "data": data}


if __name__ == "__main__":
    main()

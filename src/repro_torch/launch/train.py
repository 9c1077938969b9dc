"""Training launcher: run a ported arch (reduced or full scale) under the
JASDA executor -- the paper's interaction cycle drives the real run.

The port's counterpart of ``repro/launch/train.py``, with the same flags
plus ``--device`` (``cuda`` unless ``cpu`` is asked for):

    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon_mamba_7b \
        --reduced --device cpu --steps 20
    python -m repro_torch.launch.train --arch falcon_mamba_7b --reduced

:func:`train` builds and runs one training job from a ``ModelConfig``;
``main`` calls it with the flags' config, and the tests call it at
reduced scale.  The job registers with a ``JasdaExecutor`` on one lane,
its steps are atomized into chunks that bid into announced windows, and
each committed chunk runs real train steps.  A step is a function of its
index (the batch is ``SyntheticTokens.batch(step)``), so the executor's
losses equal a plain loop's.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from ..checkpoint import CheckpointStore
from ..configs import get, info, reduced
from ..core import JasdaScheduler, SliceSpec
from ..core.executor import JasdaExecutor, TrainingJob
from ..core.scheduler import SchedulerConfig
from ..core.windows import WindowPolicy
from ..data import DataConfig, SyntheticTokens
from ..kernels.common import resolve_device
from ..models import Model
from ..models.config import ModelConfig
from ..training import adafactor, adamw, make_train_step, warmup_cosine

__all__ = ["TrainRun", "train", "main"]

GB = 1 << 30


class TrainRun:
    """One training job's model, params, optimizer state, data and record.

    ``run_steps(s0, n)`` runs steps s0 .. s0+n-1 (the job's ``step_fn``)
    and appends each step's loss, grad norm and wall seconds (host clock
    around the step and its loss read, which waits for the device)."""

    def __init__(self, cfg: ModelConfig, *, optimizer: str = "adamw",
                 steps: int = 100, batch: int = 8, seq: int = 128,
                 device=None, init_device="cpu"):
        self.device = resolve_device(device)
        self.model = Model(cfg)
        params = _to(self.model.init(0, device=init_device), self.device)
        self.n_params = sum(p.numel() for p in _leaves(params))
        lr = warmup_cosine(3e-4, min(50, steps // 4 + 1), steps)
        self.opt = adamw(lr) if optimizer == "adamw" else adafactor(lr)
        self.state = {"params": params, "opt": self.opt.init(params)}
        self.step_fn = make_train_step(self.model, self.opt)
        self.data = SyntheticTokens(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
            memory_seq=cfg.encoder_seq or cfg.vision_seq,
            d_model=cfg.d_model if cfg.family in ("encdec", "vlm") else 0))
        self.losses: List[float] = []
        self.grad_norms: List[float] = []
        self.step_s: List[float] = []
        self.chunks: List[tuple] = []

    def run_steps(self, s0: int, n: int) -> Dict[str, float]:
        self.chunks.append((s0, n))
        loss = None
        for i in range(s0, s0 + n):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch(i).items()}
            self.state["params"], self.state["opt"], m = self.step_fn(
                self.state["params"], self.state["opt"], batch, i)
            loss = float(m["loss"])
            self.step_s.append(time.perf_counter() - t0)
            self.losses.append(loss)
            self.grad_norms.append(float(m["grad_norm"]))
        return {"loss": loss}


def train(cfg: ModelConfig, *, optimizer: str = "adamw", steps: int = 100,
          batch: int = 8, seq: int = 128, device=None, init_device="cpu",
          jasda: bool = True,
          checkpoint_fn: Optional[Callable[[int, dict], None]] = None,
          lane_bytes: float = 8 * GB, max_wall: float = 86400.0) -> TrainRun:
    """Build a training job for ``cfg`` and run ``steps`` steps of it.

    The params are drawn from seed 0 on ``init_device`` and moved to
    ``device``.  Drawn on the host (the default), they are the same for a
    run on the card and one on the host, as ``jax.random`` draws the same
    numbers on every backend; a full-width config is drawn faster on the
    card (``init_device=device``), with other numbers.  Under the executor
    (``jasda``) the job runs on one lane of ``lane_bytes``;
    ``checkpoint_fn(step, state)`` is called at every chunk boundary with
    ``{"params", "opt"}``.  Raises if the executor stops before every
    step ran."""
    run = TrainRun(cfg, optimizer=optimizer, steps=steps, batch=batch,
                   seq=seq, device=device, init_device=init_device)
    if not jasda:
        run.run_steps(0, steps)
        return run
    sched = JasdaScheduler(
        [SliceSpec("lane0", lane_bytes, n_chips=1)],
        SchedulerConfig(window=WindowPolicy(horizon=3600.0, min_gap=0.3),
                        device=str(run.device.type)))
    ex = JasdaExecutor(sched)
    job = TrainingJob(
        job_id=cfg.name, total_steps=steps, step_fn=run.run_steps,
        checkpoint_fn=(None if checkpoint_fn is None
                       else lambda s: checkpoint_fn(s, run.state)),
        param_bytes=run.n_params * 4.0, optimizer_bytes=run.n_params * 8.0,
        activation_bytes=batch * seq * cfg.d_model * 16.0,
        steps_per_sec=2.0)
    ex.register(job)
    ex.run(max_wall=max_wall)
    if job.steps_done < steps:
        raise RuntimeError(f"the executor stopped after {job.steps_done} of "
                           f"{steps} steps ({max_wall} s wall limit)")
    return run


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--no-jasda", action="store_true",
                    help="plain loop without the scheduler executor")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # float32 matmuls in full float32 on the card, as on the host
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduced(args.arch) if args.reduced else get(args.arch)
    store = CheckpointStore(args.ckpt_dir or tempfile.mkdtemp(prefix="ckpt_"))
    run = train(cfg, optimizer=info(args.arch).optimizer, steps=args.steps,
                batch=args.batch, seq=args.seq, device=device,
                jasda=not args.no_jasda,
                checkpoint_fn=lambda s, state: store.save(s, state))
    store.wait()
    print(f"{cfg.name}: {run.n_params/1e6:.1f}M params "
          f"({'reduced' if args.reduced else 'FULL'}) on {device}")
    print("losses: " + json.dumps(run.losses))
    print(f"done: loss {run.losses[0]:.3f} → {run.losses[-1]:.3f} "
          f"({len(run.losses)} steps, checkpoints at {store.steps()})")


if __name__ == "__main__":
    main()

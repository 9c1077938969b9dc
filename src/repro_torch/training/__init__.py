"""Training substrate: optimizers, schedules, train-step factory."""
from .optimizer import adafactor, adamw, apply_updates, clip_by_global_norm, global_norm  # noqa: F401
from .schedule import constant, warmup_cosine  # noqa: F401
from .trainer import make_accum_steps, make_eval_step, make_train_step  # noqa: F401

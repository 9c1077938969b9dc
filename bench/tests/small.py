"""Each cell cut to a size the CPU runs in seconds (overrides of its
parameters), and a helper that runs a cell on the CPU."""
from bench import run

SSM = {"layers": 2, "d_model": 64, "d_inner": 128, "state": 8, "conv": 4,
       "dt_rank": 4, "vocab": 512, "padded_vocab": 2048}
#: training's numbers read as on the card from d_model 256 on (at 64 the
#: program's loss gap reaches the card's limit)
WIDE = dict(SSM, layers=4, d_model=256, d_inner=512, state=16, dt_rank=16,
            vocab=2048)
#: serving keeps the published depth: bfloat16's error, and float8's, grow
#: with it (the control's logit gap reads 0.4-0.5 at 64 layers, 0.1-0.2 at 4)
DEEP = dict(SSM, layers=64, d_model=128, d_inner=256, state=16, dt_rank=8,
            vocab=2048)

SMALL = {
    "mig-pod64.stream": {"warmup_t": 3.0},
    "falcon-mamba-7b-32l.train-jasda": {"config_overrides": WIDE, "batch": 2,
                                        "seq": 64},
    "falcon-mamba-7b.chat32": {"config_overrides": DEEP, "clients": 4,
                               "slots": 4, "prompt_range": [8, 24],
                               "output_range": [4, 10], "max_seq": 64,
                               "warmup_steps": 60, "check_requests": 16},
}
#: the window, in seconds: the chat's reference reads only requests sent
#: and finished inside it, and 3 s let a dozen or more finish on the CPU
SECONDS = {"falcon-mamba-7b.chat32": 3.0}


def run_small(cell: str, seed: int, seconds: float = None, trace: int = 0,
              **more):
    """``(result line, harness)`` of one run of ``cell`` on the CPU."""
    over = dict(SMALL[cell], **more)
    if seconds is None:
        seconds = SECONDS.get(cell, 1.0)
    return run.measure(["--workload", cell, "--seed", str(seed), "--seconds",
                        str(seconds), "--trace", str(trace)],
                       device="cpu", overrides=over)

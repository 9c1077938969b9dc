"""Batched serving on the PyTorch port: continuous batching over a
slot-based KV cache.

The same example as ``examples/serve_batch.py``, through ``repro_torch``:
a small float32 decoder takes a burst of requests with different prompt
lengths and streams them through 4 shared slots — requests queue, claim
slots, decode together at mixed positions, and free slots on completion.
``--device`` is where the model runs (the CUDA card by default, or
``cpu``); ``--attn-impl pallas`` sends each prefill's attention through
the flash-attention kernel on the card (its plain version on the CPU),
``auto`` (the default) through the model's own attention.  Decode keeps
``auto``.

Run: PYTHONPATH=src python examples/serve_batch_torch.py [--device cpu]
         [--attn-impl auto|pallas]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models import Model, ModelConfig
from repro_torch.serving import Request, ServeConfig, ServingEngine


def build_model():
    """The reference example's decoder: 4 layers x d128, 8 heads on 4 kv
    heads (head dim 16), float32."""
    return ModelConfig(name="serve-demo", family="dense", n_layers=4,
                       d_model=128, n_heads=8, n_kv_heads=4, d_ff=256,
                       vocab_size=1024, model_axis_size=1,
                       dtype=torch.float32)


def run(model, params, *, device, attn_impl="auto"):
    """Serve the example's 10 seeded requests on ``device`` and print the
    reference's lines; returns the requests, engine steps and wall s."""
    cfg = model.cfg
    eng = ServingEngine(model, params,
                        ServeConfig(batch_slots=4, max_seq=128),
                        device=device, attn_impl=attn_impl)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(10):
        prompt = rng.integers(0, cfg.vocab_size, size=rng.integers(4, 24))
        reqs.append(Request(f"req-{i:02d}", prompt.astype(np.int32),
                            max_new_tokens=16))
        eng.submit(reqs[-1])

    t0 = time.perf_counter()
    steps = 0
    while True:
        active = eng.step()
        steps += 1
        if active == 0 and not eng.queue:
            break
    wall = time.perf_counter() - t0

    dev = torch.device(device)
    where = ("CPU" if dev.type == "cpu"
             else torch.cuda.get_device_name(dev))
    total_tokens = sum(len(r.output) for r in reqs)
    print(f"{len(reqs)} requests, {total_tokens} tokens generated in "
          f"{steps} engine steps ({wall:.2f}s, "
          f"{total_tokens / wall:.1f} tok/s on {where})")
    for r in reqs[:3]:
        print(f"  {r.request_id}: prompt[{len(r.prompt)}] → {r.output}")
    assert all(r.done for r in reqs)
    return reqs, steps, wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    ap.add_argument("--attn-impl", default="auto", choices=("auto", "pallas"),
                    help="attention of each prefill (decode keeps auto)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model = Model(build_model())
    params = model.init(0, device=device)
    return run(model, params, device=device, attn_impl=args.attn_impl)


if __name__ == "__main__":
    main()

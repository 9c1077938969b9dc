"""``compressed_allreduce`` over 4 gloo processes against the JAX package's.

Four ranks of a ``torch.distributed`` gloo group (one process each, on the
host) reduce their own seeded float32 gradients and error buffers; the
reference runs ``repro.distributed.compression.compressed_allreduce``
under ``shard_map`` on 4 virtual XLA host devices in a subprocess.  The
reduced gradients (the same on every rank) and each rank's new error
buffer must agree within 1e-6.  The reduction rescales by the MEAN of
the per-block scales, so it is held to the reference, not to the plain
mean of the gradients (they differ by about 0.1 on N(0, 1) inputs).
"""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
#: leaf shapes: a 2-D leaf whose size is no multiple of the 2048-value
#: block, and a nested 1-D one shorter than a block
SHAPES = {"w": (3, 2500), "c": (100,)}

PORT_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import compressed_allreduce

    rank, world, addr, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=addr, rank=rank,
                            world_size=world)
    x = np.load(f"{d}/in.npz")
    t = lambda k: torch.from_numpy(x[f"{k}{rank}"])
    red, err = compressed_allreduce({"w": t("w"), "b": {"c": t("c")}},
                                    {"w": t("ew"), "b": {"c": t("ec")}})
    np.savez(f"{d}/port{rank}.npz", w=red["w"].numpy(), c=red["b"]["c"].numpy(),
             ew=err["w"].numpy(), ec=err["b"]["c"].numpy())
    dist.barrier()
    dist.destroy_process_group()
""")

REFERENCE = textwrap.dedent("""
    import sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.distributed.compression import compressed_allreduce

    world, d = int(sys.argv[1]), sys.argv[2]
    x = np.load(f"{d}/in.npz")
    stack = lambda k: jnp.stack([x[f"{k}{r}"] for r in range(world)])
    mesh = Mesh(np.array(jax.devices()[:world]), ("d",))

    def per_device(w, c, ew, ec):
        red, err = compressed_allreduce({"w": w[0], "b": {"c": c[0]}},
                                        {"w": ew[0], "b": {"c": ec[0]}}, "d")
        return (red["w"][None], red["b"]["c"][None], err["w"][None],
                err["b"]["c"][None])

    f = jax.jit(jax.shard_map(per_device, mesh=mesh, in_specs=(P("d"),) * 4,
                              out_specs=(P("d"),) * 4))
    w, c, ew, ec = (np.asarray(a) for a in f(stack("w"), stack("c"),
                                             stack("ew"), stack("ec")))
    for r in range(world):
        np.savez(f"{d}/ref{r}.npz", w=w[r], c=c[r], ew=ew[r], ec=ec[r])
""")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.update(kw)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("allreduce")
    rng = np.random.default_rng(0)
    arrays = {}
    for r in range(WORLD):
        for k, shape in SHAPES.items():
            arrays[f"{k}{r}"] = rng.standard_normal(shape).astype(np.float32)
            arrays[f"e{k}{r}"] = (rng.standard_normal(shape) * 1e-3).astype(
                np.float32)
    np.savez(d / "in.npz", **arrays)
    (d / "rank.py").write_text(PORT_RANK)
    (d / "ref.py").write_text(REFERENCE)

    addr = f"tcp://127.0.0.1:{_free_port()}"
    ranks = [subprocess.Popen(
        [sys.executable, str(d / "rank.py"), str(r), str(WORLD), addr, str(d)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    flags = ("--xla_force_host_platform_device_count=4 "
             + os.environ.get("XLA_FLAGS", "")).strip()
    ref = subprocess.run([sys.executable, str(d / "ref.py"), str(WORLD), str(d)],
                         env=_env(XLA_FLAGS=flags), capture_output=True,
                         text=True, timeout=240)
    try:
        outs = [p.communicate(timeout=240) for p in ranks]
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(ranks, outs):
        assert p.returncode == 0, err[-3000:]
    assert ref.returncode == 0, ref.stderr[-3000:]
    load = lambda name: [dict(np.load(d / f"{name}{r}.npz")) for r in range(WORLD)]
    return arrays, load("port"), load("ref")


@pytest.mark.parametrize("leaf", ["w", "c"])
def test_reduced_equals_the_reference(runs, leaf):
    _, port, ref = runs
    for r in range(WORLD):
        np.testing.assert_allclose(port[r][leaf], ref[r][leaf], atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_array_equal(port[r][leaf], port[0][leaf])


@pytest.mark.parametrize("leaf", ["w", "c"])
def test_new_error_equals_the_reference(runs, leaf):
    _, port, ref = runs
    for r in range(WORLD):
        np.testing.assert_allclose(port[r]["e" + leaf], ref[r]["e" + leaf],
                                   atol=1e-6, rtol=1e-6)


def test_not_the_plain_mean(runs):
    """The scale mean is an approximation: the reduction is near the mean
    of the gradients but not equal to it."""
    arrays, port, _ = runs
    mean = np.mean([arrays[f"w{r}"] + arrays[f"ew{r}"] for r in range(WORLD)],
                   axis=0)
    gap = np.abs(port[0]["w"] - mean).max()
    assert 1e-3 < gap < 1.0

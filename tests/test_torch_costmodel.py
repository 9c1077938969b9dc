"""The port's cost model, roofline and report against the JAX package.

``launch/costmodel.py`` is the reference's code: its ``analytic_cost`` (for
each attention implementation) and ``model_flops`` must equal the
reference's exactly for every arch and shape.  ``launch/roofline.py``
holds H100 constants; with the reference's v5e constants patched in, a
``Roofline`` row equals the reference's.  The collectives the port counts
from the rules are checked on cases computed by hand, and the report's
tables must be the reference's byte for byte on one jsonl of ok, skipped
and error rows.
"""
import json
import math

import pytest
import torch

from repro.configs import get as ref_get
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.launch import costmodel as ref_costmodel
from repro.launch import report as ref_report
from repro.launch import roofline as ref_roofline
from repro_torch.configs import ARCH_NAMES, SHAPES, get, info
from repro_torch.configs.registry import ArchInfo
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import costmodel, report, roofline
from repro_torch.launch.mesh import Mesh
from repro_torch.models import ModelConfig

CELLS = [(a, s) for a in ARCH_NAMES for s in SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_cost_and_model_flops_equal_the_reference(arch, shape):
    cfg, inf, shp = get(arch), info(arch), SHAPES[shape]
    rcfg, rinf = ref_get(arch)
    rshp = REF_SHAPES[shape]
    assert (shp.name, shp.kind, shp.seq, shp.batch) == \
        (rshp.name, rshp.kind, rshp.seq, rshp.batch)
    for impl in ("chunked", "triangle", "full"):
        got = costmodel.analytic_cost(cfg, inf, shp, attn_impl=impl)
        want = ref_costmodel.analytic_cost(rcfg, rinf, rshp, attn_impl=impl)
        assert got.flops_global == want.flops_global
        assert got.param_traffic == want.param_traffic
        assert got.stream_traffic == want.stream_traffic
        assert got.detail == want.detail
        for chips, repl in ((256, False), (512, True)):
            assert got.bytes_per_device(chips, params_replicated=repl) == \
                want.bytes_per_device(chips, params_replicated=repl)
    assert roofline.model_flops(cfg, shp) == ref_roofline.model_flops(rcfg, rshp)


def test_h100_constants():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9


@pytest.mark.parametrize("arch,shape", [("qwen3_14b", "prefill_32k"),
                                        ("olmoe_1b_7b", "train_4k"),
                                        ("falcon_mamba_7b", "decode_32k")])
def test_roofline_row_equals_the_reference_at_its_constants(arch, shape,
                                                            monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(roofline, name, getattr(ref_roofline, name))
    cfg, shp = get(arch), SHAPES[shape]
    ac = costmodel.analytic_cost(cfg, info(arch), shp)
    kinds = {"all-gather": 3.5e9, "all-reduce": 1.25e8, "all-to-all": 7e6}
    rows = []
    for mod in (roofline, ref_roofline):
        coll = mod.CollectiveStats()
        for kind, b in kinds.items():
            coll.add(kind, b)
        rows.append(mod.Roofline(
            arch=arch, shape=shape, mesh="single", chips=256,
            flops_per_device=ac.flops_global / 256,
            bytes_per_device=ac.bytes_per_device(256, params_replicated=False),
            collective=coll, model_flops_global=roofline.model_flops(cfg, shp),
            memory_stats={"argument_bytes": 1 << 30}).row())
    assert rows[0] == rows[1]
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute", "send"):
        for g in (2, 16):
            assert roofline._op_link_bytes(kind, 1e6, g) == \
                ref_roofline._op_link_bytes(kind, 1e6, g)


# ---------------------------------------------------------------------------
# Collectives implied by the rules, by hand
# ---------------------------------------------------------------------------


def _mesh(data, model):
    return Mesh((torch.device("meta"),) * (data * model), ("data", "model"),
                (data, model))


def _tiny(**kw):
    base = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=100,
                gated_mlp=False, act="gelu", model_axis_size=4,
                dtype=torch.bfloat16)
    base.update(kw)
    return ModelConfig(**base)


def test_collectives_pure_data_parallel_train():
    """Params replicated: each leaf's gradient all-reduces over the 8-way
    batch, once per microbatch; no activation collective."""
    cfg = _tiny()
    mesh = _mesh(8, 1)
    rules = ShardingRules(mesh=mesh, fsdp_axes=(), model_axes=(),
                          batch_axes=("data",))
    shape = SHAPES["train_4k"]
    inf = ArchInfo(microbatches={"train_4k": 2})
    st = roofline.collective_bytes_from_rules(cfg, inf, shape, rules)
    from repro_torch.models.params import build_template, P

    def leaves(t):
        if isinstance(t, P):
            yield t
        else:
            for v in t.values():
                yield from leaves(v)

    total = sum(math.prod(p.shape) * (p.dtype or cfg.dtype).itemsize
                for p in leaves(build_template(cfg)))
    n_leaves = sum(1 for _ in leaves(build_template(cfg)))
    assert set(st.by_kind) == {"all-reduce"}
    assert st.count == 2 * n_leaves
    assert st.bytes_on_link == pytest.approx(2 * 2 * total * 7 / 8)


def test_collectives_fsdp_and_tensor_parallel_prefill():
    """(data=2, model=4), prefill: each fsdp-sharded leaf is gathered once
    over data (its model shard); each of the 2 layers all-reduces its
    attention and MLP outputs over model; heads mode needs no all-to-all."""
    cfg = _tiny()
    rules = ShardingRules(mesh=_mesh(2, 4), batch_axes=("data",))
    shape = SHAPES["prefill_32k"]  # batch 32, seq 32768
    st = roofline.collective_bytes_from_rules(cfg, ArchInfo(), shape, rules)
    D, F, H, hd, Vp = 64, 128, 4, 16, cfg.padded_vocab
    L = 2
    # bf16 leaves with a "fsdp" entry, on their model shard (/4)
    gathered = 2 * (Vp * D + D * Vp                 # embed, unembed
                    + L * 4 * D * H * hd            # wq wk wv wo
                    + L * 2 * D * F) / 4            # w_up w_down
    ag = gathered * (2 - 1) / 2
    btd = 32 / 2 * 32768 * D * 2                    # local rows x seq x D, bf16
    ar = 2 * L * (2 * btd * 3 / 4)                  # attn + mlp per layer
    assert st.by_kind["all-gather"] == pytest.approx(ag)
    assert st.by_kind["all-reduce"] == pytest.approx(ar)
    assert set(st.by_kind) == {"all-gather", "all-reduce"}
    assert st.count == 8 + 2 * L                    # 8 fsdp leaves, 4 blocks


def test_collectives_headdim_ulysses_and_moe_dispatch():
    """A headdim MoE at decode and at prefill: Ulysses all-to-alls and the
    k/v all-gathers only where S > 1; expert dispatch all-to-alls both
    ways per MoE layer."""
    cfg = _tiny(family="moe", n_layers=1, n_experts=8, top_k=2, d_expert=32,
                attn_shard="headdim", gated_mlp=True, act="silu")
    rules = ShardingRules(mesh=_mesh(2, 4), fsdp_axes=(),
                          batch_axes=("data",), attn_shard="headdim")
    D, H, Hkv, hd = 64, 4, 4, 16
    pre = roofline.collective_bytes_from_rules(cfg, ArchInfo(),
                                               SHAPES["prefill_32k"], rules)
    rows, t = 16, 32768
    cap = int(512 * 2 / 8 * 1.25) + 1
    gecd = rows * t / 512 * 8 * cap * D * 2 / 4
    q = rows * t * H * hd * 2 / 4
    kv = rows * t * Hkv * hd * 2
    assert pre.by_kind["all-to-all"] == pytest.approx(
        2 * gecd * 3 / 4 + 2 * q * 3 / 4)
    assert pre.by_kind["all-gather"] == pytest.approx(2 * kv * 3 / 4)
    assert pre.by_kind["all-reduce"] == pytest.approx(2 * rows * t * D * 2 * 3 / 4)
    dec = roofline.collective_bytes_from_rules(cfg, ArchInfo(),
                                               SHAPES["decode_32k"], rules)
    assert "all-gather" not in dec.by_kind      # no Ulysses at S == 1
    rows = 128 / 2
    gecd = rows * 1 / 1 * 8 * (int(1 * 2 / 8 * 1.25) + 1) * D * 2 / 4
    assert dec.by_kind["all-to-all"] == pytest.approx(2 * gecd * 3 / 4)


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------


def _row(arch, shape, mesh, **kw):
    row = {"arch": arch, "shape": shape, "mesh": mesh, "chips": 256,
           "flops_per_device": 1.5e12, "bytes_per_device": 3.0e10,
           "collective_bytes_per_device": 2.0e10,
           "collective_by_kind": {"all-gather": 1.5e10, "all-reduce": 5e9},
           "n_collectives": 412, "t_compute_s": 0.0151, "t_memory_s": 2.5,
           "t_collective_s": 0.4, "bottleneck": "memory",
           "model_flops_global": 2e14, "model_vs_hlo": 0.52,
           "roofline_fraction": 0.0123,
           "memory": {"argument_bytes": 3 << 30, "temp_bytes": None},
           "t_lower_s": 1.2}
    row.update(kw)
    return row


def test_report_is_the_references_byte_for_byte(tmp_path, capsys):
    rows = [
        _row("qwen3_14b", "train_4k", "single"),
        _row("qwen3_14b", "train_4k", "multi", t_collective_s=0.9,
             bottleneck="collective"),
        _row("qwen3_14b", "prefill_32k", "single", bottleneck="compute",
             t_compute_s=3.0),
        {"arch": "qwen3_14b", "shape": "long_500k", "mesh": "single",
         "skipped": "full attention at 524k seq is quadratic"},
        {"arch": "qwen3_14b", "shape": "decode_32k", "mesh": "single",
         "error": "boom"},
        _row("falcon_mamba_7b", "long_500k", "single", t_compile_s=3.0,
             memory=None),
    ]
    path = tmp_path / "dryrun.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows) + "not json\n")
    report.main(str(path))
    got = capsys.readouterr().out
    ref_report.main(str(path))
    want = capsys.readouterr().out
    assert got == want
    assert "| qwen3_14b | decode_32k | single | ERROR |" in got

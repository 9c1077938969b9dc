"""The port's dry run on meta tensors.

``run_cell`` builds a cell at full width on the ``meta`` device and fills
the reference's row: the ``Roofline.row()`` keys, ``t_lower_s`` and
``cost_detail``, with flops and bytes from the analytic model, collectives
from the rules and ``memory.argument_bytes`` from the inputs' placements.
The meta run's FLOP count must fall in the band ``flop_counter_band``
states for the cell.  The launcher's CLI writes rows incrementally and the
report reads them.  Meta tensors never reach a kernel: the linear scan
returns shape-only outputs in both directions.
"""
import json
import math

import pytest
import torch

from repro.launch import roofline as ref_roofline
from repro_torch.configs import SHAPES, get, info
from repro_torch.kernels.linear_scan import kernel as k5
from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.launch import dryrun, report
from repro_torch.launch.costmodel import analytic_cost

REF_ROW_KEYS = set(ref_roofline.Roofline(
    arch="a", shape="s", mesh="single", chips=1, flops_per_device=1.0,
    bytes_per_device=1.0, collective=ref_roofline.CollectiveStats(),
    model_flops_global=1.0).row()) | {"t_lower_s", "cost_detail"}


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("qwen1_5_4b", "prefill_32k", False),
    ("falcon_mamba_7b", "decode_32k", False),
    ("olmoe_1b_7b", "decode_32k", False),
    ("recurrentgemma_9b", "prefill_32k", False),
    ("llama3_405b", "train_4k", True),
    ("whisper_small", "train_4k", False),
])
def test_run_cell_at_full_width(arch, shape, multi_pod):
    row = dryrun.run_cell(arch, shape, multi_pod=multi_pod, verbose=False)
    assert REF_ROW_KEYS <= set(row)
    assert row["mesh"] == ("multi" if multi_pod else "single")
    chips = 512 if multi_pod else 256
    assert row["chips"] == chips
    cfg, inf, shp = get(arch), info(arch), SHAPES[shape]
    ac = analytic_cost(cfg, inf, shp,
                       attn_impl="chunked" if shp.seq > 8192 else "full")
    assert row["flops_per_device"] * chips == ac.flops_global
    assert row["cost_detail"] == ac.detail
    lo, hi, why = dryrun.flop_counter_band(cfg, shp)
    ratio = row["flop_counter"]["flops_global"] / ac.flops_global
    assert lo <= ratio <= hi, (ratio, why)
    mem = row["memory"]
    assert mem["temp_bytes"] is None and mem["argument_bytes"] > 0
    assert row["n_collectives"] > 0 and row["t_collective_s"] > 0
    json.dumps(row)


def test_argument_bytes_by_hand():
    """falcon-mamba-7b decode_32k on the single pod: the decode inputs'
    per-device bytes, batch on data (16) and the state's channels on
    model (16)."""
    row = dryrun.run_cell("falcon_mamba_7b", "decode_32k", multi_pod=False,
                          verbose=False)
    cfg = get("falcon_mamba_7b")
    L, B, Dm, N, K = 64, 128, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    conv = L * B * (K - 1) * Dm * 2 / 256
    ssm = L * B * Dm * N * 4 / 256
    tokens = 2 * B * 4 / 16
    assert row["argument_bytes_by_input"]["inputs"] == conv + ssm + tokens
    assert row["memory"]["argument_bytes"] == sum(
        row["argument_bytes_by_input"].values())


def test_long_context_skip_and_cli(tmp_path, capsys):
    """The launcher writes a row a cell, skips a cell it has, and the report
    reads the file; long_500k is skipped where the reference skips it."""
    out = tmp_path / "d.jsonl"
    argv = ["--arch", "whisper_small", "--shape", "long_500k", "--mesh",
            "single", "--out", str(out)]
    dryrun.main(argv)
    rows = [json.loads(x) for x in out.read_text().splitlines()]
    assert rows == [{"arch": "whisper_small", "shape": "long_500k",
                     "mesh": "single", "skipped": rows[0]["skipped"]}]
    dryrun.main(argv)
    assert "[cached]" in capsys.readouterr().out
    assert len(out.read_text().splitlines()) == 1
    report.main(str(out))
    assert "| whisper_small | long_500k | single | skip (quadratic@524k) |" \
        in capsys.readouterr().out


def test_meta_scan_is_shape_only():
    """On meta tensors the scan launches nothing and runs no loop over T,
    forward or backward; its outputs have the plain version's shapes."""
    before = dict(k5.LAUNCHES)
    a = torch.empty(2, 32768, 64, device="meta", requires_grad=True)
    b = torch.empty(2, 32768, 64, device="meta", requires_grad=True)
    h0 = torch.empty(2, 64, device="meta", requires_grad=True)
    for impl in (None, "cuda", "torch"):
        h, h_t = linear_scan(a, b, h0, impl=impl)
        assert h.is_meta and h.shape == a.shape and h_t.shape == (2, 64)
        da, db, dh0 = torch.autograd.grad(h.sum() + h_t.sum(), (a, b, h0))
        assert da.shape == a.shape and db.shape == b.shape
        assert dh0.shape == h0.shape and da.is_meta
    assert k5.LAUNCHES == before


def test_depth_extrapolation_is_exact():
    """Counting at one and two superblocks and extrapolating gives what the
    full depth counts (qwen1.5-4b cut to 5 layers)."""
    cfg = get("qwen1_5_4b").replace(n_layers=5)
    shape = SHAPES["decode_32k"]
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(devices=["meta"] * 256)
    rules = dryrun.build_rules(cfg, info("qwen1_5_4b"), shape, mesh,
                               multi_pod=False)
    count = [dryrun._count_flops(dryrun._cut(cfg, k), info("qwen1_5_4b"),
                                 shape, rules, "auto", 1, None)
             for k in (1, 2, 5)]
    assert count[0] + 4 * (count[1] - count[0]) == count[2]
    assert math.isclose(count[2], analytic_cost(
        cfg, info("qwen1_5_4b"), shape).flops_global, rel_tol=1e-9)

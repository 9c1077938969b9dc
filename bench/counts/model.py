"""Model FLOPs of the state-space configurations: a frozen copy of the
port's ``launch/roofline.py::model_flops`` with the mamba-1 parameter count
of ``models/config.py::param_count``.

A step's model FLOPs are ``6 N tokens`` in training and ``2 N tokens`` in
inference, where N counts the embedding and the (untied) unembedding over
the padded vocabulary and, in each layer, the input projection, the
convolution, the x, dt and output projections, A and D.
"""
from __future__ import annotations


def ssm_params(cfg: dict) -> int:
    d, dm, n, r, k = (cfg["d_model"], cfg["d_inner"], cfg["state"],
                      cfg["dt_rank"], cfg["conv"])
    per_layer = (d * 2 * dm + dm * k + dm * (r + 2 * n) + r * dm + dm * n
                 + dm + dm * d)
    return cfg["padded_vocab"] * d * 2 + cfg["layers"] * per_layer


def train_flops(cfg: dict, tokens: int) -> float:
    return 6.0 * ssm_params(cfg) * tokens


def inference_flops(cfg: dict, tokens: int) -> float:
    return 2.0 * ssm_params(cfg) * tokens

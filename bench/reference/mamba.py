"""Plain float32 falcon-mamba (mamba-1): forward, loss, three AdamW steps.

The architecture of arXiv:2410.05355 as the configuration file states it:
token embedding; per layer ``x + mixer(rms_norm(x) (1 + scale))``; a final
RMSNorm; an untied unembedding over the padded vocabulary (entries past
the real vocabulary masked out of the loss).  The mixer: an input
projection to (x, z) of width ``d_inner``; a causal depthwise convolution
of ``conv`` taps and SiLU on x; a projection of x to (dt of rank R, B, C of
width ``state``); ``dt = softplus(dt W + b)``; the selective scan
``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t`` with ``A = -exp(a_log)``,
composed by doubling; ``y = h_t C_t + D x_t``, gated by ``silu(z)``; the
output projection.

Weights are read in whatever dtype they are stored in and computed in
float32 (``torch.backends.cuda.matmul.allow_tf32`` off).  ``low`` turns
the reference into the control: every matmul operand rounded through that
dtype (float8 e4m3 with a per-tensor scale, the precision below bfloat16).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


#: elements of a piece of a leaf in the optimizer's update
PIECE = 1 << 26


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, low) -> torch.Tensor:
    """``x`` rounded through ``low`` with a per-tensor scale to its range;
    the gradient passes straight through."""
    if low is None:
        return x
    top = torch.finfo(low).max
    amax = x.detach().abs().amax().clamp(min=1e-30)
    q = (x.detach() * (top / amax)).to(low).to(torch.float32) * (amax / top)
    return x + (q - x).detach()


def _mm(eq: str, a: torch.Tensor, w: torch.Tensor, low) -> torch.Tensor:
    return torch.einsum(eq, _round(a, low), _round(w.float(), low))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def scan(da: torch.Tensor, dbx: torch.Tensor) -> torch.Tensor:
    """h_t = da_t h_{t-1} + dbx_t from h_{-1} = 0, for every t of (B, S, ...):
    the same sums, composed by doubling (after step k each h_t holds the
    terms from t - 2k + 1 on), so that S steps take log2(S) passes."""
    a, h = da, dbx
    k = 1
    while k < h.shape[1]:
        h = torch.cat([h[:, :k], a[:, k:] * h[:, :-k] + h[:, k:]], 1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], 1)
        k *= 2
    return h


#: channels of the scan composed at once (its doubling keeps log2(S)
#: copies alive for the backward pass, so wide scans go in blocks)
SCAN_ELEMENTS = 1 << 27


def scan_blocks(da: torch.Tensor, dbx: torch.Tensor) -> torch.Tensor:
    """:func:`scan` over blocks of the channel axis (dim 2), each block
    recomputed in the backward pass rather than kept."""
    n = max(1, -(-da.numel() // SCAN_ELEMENTS))
    if n == 1:
        return scan(da, dbx)
    step = -(-da.shape[2] // n)
    return torch.cat([checkpoint(scan, da[:, :, i:i + step], dbx[:, :, i:i + step],
                                 use_reentrant=False)
                      for i in range(0, da.shape[2], step)], 2)


def mixer(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: dict, low=None):
    b, s, _ = x.shape
    k, n, r = cfg["conv"], cfg["state"], cfg["dt_rank"]
    xz = _mm("bsd,dcm->bscm", x, p["in_proj"], low)
    x1, z = xz[:, :, 0], xz[:, :, 1]
    xp = F.pad(x1, (0, 0, k - 1, 0))
    w = p["conv_w"].float()
    conv = sum(w[i] * xp[:, i:i + s] for i in range(k)) + p["conv_b"].float()
    x1 = F.silu(conv)
    proj = _mm("bsd,dr->bsr", x1, p["x_proj"], low)
    dt_r, bm, cm = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus(_mm("bsr,rd->bsd", dt_r, p["dt_proj"], low)
                    + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    da = torch.exp(dt[..., None] * a)
    dbx = (dt * x1)[..., None] * bm[:, :, None, :]
    h = scan_blocks(da, dbx)
    y = torch.einsum("bsdn,bsn->bsd", h, cm) + p["d_skip"].float() * x1
    y = y * F.silu(z)
    return _mm("bsm,md->bsd", y, p["out_proj"], low)


def layer(x, p, cfg, low=None):
    return x + mixer(rms_norm(x, p["ln1_scale"], cfg["norm_eps"]), p, cfg, low)


def _layer_params(params, i: int) -> Dict[str, torch.Tensor]:
    blk = params["blocks"]["b0_mamba"]
    out = {k: v[i] for k, v in blk["mamba"].items()}
    out["ln1_scale"] = blk["ln1_scale"][i]
    return out


def logits(params, tokens: torch.Tensor, cfg: dict, *, low=None,
           remat: bool = False) -> torch.Tensor:
    """(B, S) tokens → (B, S, padded vocab) float32 logits."""
    x = params["embed"][tokens.long()].float()
    for i in range(cfg["layers"]):
        p = _layer_params(params, i)
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, p, cfg, low, use_reentrant=False)
        else:
            x = layer(x, p, cfg, low)
    x = rms_norm(x, params["final_norm"], cfg["norm_eps"])
    return _mm("bsd,dv->bsv", x, params["unembed"], low)


def loss(params, tokens, labels, cfg: dict, *, low=None) -> torch.Tensor:
    """Mean next-token cross entropy over the real vocabulary."""
    lg = logits(params, tokens, cfg, low=low, remat=True)
    lg = lg[..., :cfg["vocab"]]
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1).long())


def lr_at(step: int, peak: float, warmup: int, total: int,
          final_frac: float = 0.1) -> float:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine to
    ``final_frac`` of it at ``total``."""
    if step < warmup:
        return peak * (step + 1) / max(warmup, 1)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t)))


def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def train(params, batches: List[dict], cfg: dict, opt: dict, *, low=None):
    """The configuration's steps on ``params`` (updated in place, kept in
    their own dtype): loss in float32, each leaf's gradient in its dtype
    (computed in float32 through the network, rounded at the leaf, as the
    configuration's bfloat16 params have it), the gradient clipped
    to a global norm of ``opt["clip"]``, AdamW (float32 moments, no decay
    on vectors), each param updated as ``(p in f32 + u)`` rounded to its
    dtype.  Returns each step's loss and the first clipped gradient's norm
    by leaf."""
    named = leaves(params)
    m = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
         for k, v in named.items()}
    v2 = {k: torch.zeros_like(t) for k, t in m.items()}
    losses, first = [], None
    for step, batch in enumerate(batches):
        live = {k: t.detach().requires_grad_(True) for k, t in named.items()}
        tree = _rebuild(params, live)
        with torch.enable_grad():
            value = loss(tree, batch["tokens"], batch["labels"], cfg, low=low)
            grads = torch.autograd.grad(value, list(live.values()))
        losses.append(float(value.detach()))
        del live, tree
        gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        scale = torch.clamp(opt["clip"] / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = lr_at(step, opt["peak_lr"], opt["warmup"], opt["total_steps"])
        b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
        c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
        norms = {}
        with torch.no_grad():
            for (k, p), g in zip(named.items(), grads):
                decay = wd if p.dim() >= 2 else 0.0
                sq = 0.0
                # a leaf a layer stack of up to 2^31 elements: in pieces
                rows = max(1, PIECE // max(1, p[0].numel())) if p.dim() else 1
                for i in range(0, max(1, p.shape[0] if p.dim() else 1), rows):
                    sl = slice(i, i + rows) if p.dim() else slice(None)
                    gg = g[sl].float() * scale
                    sq += float((gg * gg).sum())
                    mm, vv, pp = m[k][sl], v2[k][sl], p[sl]
                    mm.mul_(b1).add_((1 - b1) * gg)
                    vv.mul_(b2).add_((1 - b2) * gg * gg)
                    u = (mm / c1) / (torch.sqrt(vv / c2) + eps) + decay * pp.float()
                    pp.copy_((pp.float() - lr * u).to(p.dtype))
                if step == 0:
                    norms[k] = math.sqrt(sq)
        if step == 0:
            first = norms
        del grads
    return losses, first


def _rebuild(tree, flat: Dict[str, torch.Tensor], prefix: str = ""):
    out = {}
    for k, v in tree.items():
        out[k] = (_rebuild(v, flat, f"{prefix}{k}.") if isinstance(v, dict)
                  else flat[prefix + k])
    return out

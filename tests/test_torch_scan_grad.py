"""The linear scan's gradient (K5's backward) against the JAX package.

The port's scan runs through one ``torch.autograd.Function``; on the CPU
its forward and backward are the plain loops of ``kernels/linear_scan/
ref.py`` (the CUDA backward is held bit-equal to that loop on the card by
``tests/test_torch_card_kernels.py``).  Seeded numpy inputs and cotangents
go through ``jax.vjp`` of the reference's ``linear_scan_associative`` and
through the port's backward; tolerance 1e-4, the reference suite's scan
tolerance (``tests/test_kernels.py``): the associative scan sums in another
order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as ref_reduced
from repro.kernels.linear_scan.ref import linear_scan_associative
from repro.models import Model as RefModel
from repro_torch import convert
from repro_torch.checkpoint.store import tree_flatten
from repro_torch.configs import reduced
from repro_torch.kernels.linear_scan import kernel as k5
from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.kernels.linear_scan.ref import (linear_scan_bwd_reference,
                                                 linear_scan_reference)
from repro_torch.models import Model

ATOL = 1e-4
B, T, D = 2, 37, 64


def _inputs(seed, b=B, t=T, d=D):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.8, 0.999, (b, t, d)).astype(np.float32)
    x = (rng.standard_normal((b, t, d)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    gh = rng.standard_normal((b, t, d)).astype(np.float32)
    ghT = rng.standard_normal((b, d)).astype(np.float32)
    return a, x, h0, gh, ghT


def _port_grads(a, x, h0, gh, ghT, impl="torch"):
    """(da, db, dh0) of sum(h·gh) + sum(h_T·ghT) through ``linear_scan``."""
    ta = torch.from_numpy(a).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_(True)
    h, h_t = linear_scan(ta, tx, th0, impl=impl)
    loss = (h * torch.from_numpy(gh)).sum()
    if ghT is not None:
        loss = loss + (h_t * torch.from_numpy(ghT)).sum()
    loss.backward()
    return ta.grad.numpy(), tx.grad.numpy(), (None if th0 is None
                                              else th0.grad.numpy())


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("with_ghT", [True, False])
def test_backward_matches_jax_vjp(with_h0, with_ghT):
    a, x, h0, gh, ghT = _inputs(1 + 2 * with_h0 + with_ghT)
    h0 = h0 if with_h0 else None
    ghT = ghT if with_ghT else None
    args = (jnp.asarray(a), jnp.asarray(x)) + ((jnp.asarray(h0),) if with_h0 else ())
    fn = (lambda a_, x_, h_: linear_scan_associative(a_, x_, h_)) if with_h0 \
        else (lambda a_, x_: linear_scan_associative(a_, x_))
    (h_ref, hT_ref), vjp = jax.vjp(fn, *args)
    ct_T = jnp.zeros_like(hT_ref) if ghT is None else jnp.asarray(ghT)
    ref = vjp((jnp.asarray(gh), ct_T))
    for impl in ("torch", "cuda"):  # "cuda" runs the plain loops on the CPU
        got = _port_grads(a, x, h0, gh, ghT, impl=impl)
        for name, g, r in zip(("da", "db", "dh0"), got, ref):
            np.testing.assert_allclose(g, np.asarray(r), atol=ATOL,
                                       err_msg=f"{impl} {name}")
        if not with_h0:
            assert got[2] is None


@pytest.mark.parametrize("with_h0", [True, False])
def test_backward_matches_autograd_through_the_plain_loop(with_h0):
    """The hand-written reverse loop against torch autograd differentiating
    the forward loop op by op (same float32 arithmetic, other order)."""
    a, x, h0, gh, ghT = _inputs(7)
    h0 = h0 if with_h0 else None
    ta = torch.from_numpy(a).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_(True)
    h, h_t = linear_scan_reference(ta, tx, th0)  # recorded by autograd
    ((h * torch.from_numpy(gh)).sum() + (h_t * torch.from_numpy(ghT)).sum()).backward()
    got = _port_grads(a, x, h0, gh, ghT)
    np.testing.assert_allclose(got[0], ta.grad.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1], tx.grad.numpy(), rtol=1e-6, atol=1e-6)
    if with_h0:
        np.testing.assert_allclose(got[2], th0.grad.numpy(), rtol=1e-6, atol=1e-6)


def test_bf16_backward_is_the_plain_backward():
    """bfloat16 inputs: the Function's backward returns the plain reverse
    loop's da, db (bfloat16) and dh0 bit for bit."""
    a, x, h0, gh, ghT = (torch.from_numpy(v).to(torch.bfloat16)
                         for v in _inputs(11))
    ta, tx, th0 = (t.clone().requires_grad_(True) for t in (a, x, h0))
    h, h_t = linear_scan(ta, tx, th0, impl="cuda")
    torch.autograd.backward((h, h_t), (gh, ghT))
    out, _ = linear_scan_reference(a, x, h0)
    da, db, dh0 = linear_scan_bwd_reference(a, out, h0, gh, ghT)
    assert ta.grad.dtype == tx.grad.dtype == torch.bfloat16
    assert torch.equal(ta.grad, da) and torch.equal(tx.grad, db)
    assert torch.equal(th0.grad, dh0.to(torch.bfloat16))


def test_cpu_backward_counts_no_kernel_launch():
    a, x, h0, gh, ghT = _inputs(3)
    before = dict(k5.LAUNCHES)
    _port_grads(a, x, h0, gh, ghT, impl="cuda")
    assert k5.LAUNCHES == before


def test_no_grad_inputs_build_no_graph():
    a, x, _, _, _ = _inputs(5)
    h, h_t = linear_scan(torch.from_numpy(a), torch.from_numpy(x))
    assert h.grad_fn is None and h_t.grad_fn is None


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_9b"])
def test_remat_on_and_off_give_the_same_grads(arch):
    """Checkpointing each block changes no value: loss and every gradient
    are bit-equal with and without remat."""
    cfg = ref_reduced(arch)
    ref_model = RefModel(cfg)
    params = convert.model_params(ref_model.init(jax.random.PRNGKey(0)),
                                  device="cpu")
    model = Model(reduced(arch))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    out = []
    leaves, rebuild = tree_flatten(params)
    for remat in (True, False):
        req = [p.detach().clone().requires_grad_(True) for p in leaves]
        loss = model.loss_fn(rebuild(req), batch, remat=remat)
        grads = torch.autograd.grad(loss, req)
        out.append((loss.detach(), grads))
    assert torch.equal(out[0][0], out[1][0])
    for g1, g2 in zip(out[0][1], out[1][1]):
        assert torch.equal(g1, g2)


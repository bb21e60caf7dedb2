"""The port's LRN (``theanompi_tpu_torch.ops.lrn``; its plain version
on the CPU) against the reference's fused Pallas kernel
(``theanompi_tpu.ops.pallas_lrn.lrn``, interpret mode on the CPU), and
the port's band-matmul layer path against the reference's.

Inputs are post-ReLU activations made from a seed with numpy, C = 96,
2·9·37 = 666 rows (not a multiple of the reference kernel's 512-row
block, so its padded tail block runs).  Tolerances: fp32 rtol = atol =
1e-5 (both compute in fp32; the window sums run in other orders, a
band matmul there and slice sums here); bf16 one bf16 step (rtol 2⁻⁷,
atol 1e-6): the fp32 results differ by ~1e-7 and the final rounding to
bf16 may then fall on either side.  The band-matmul layer path in bf16
is differentiated by each framework's autodiff, which rounds its
intermediate cotangents to bf16 in other places, and dx = a − b
cancels: there a difference may also reach one bf16 step of the
tensor's largest value (atol 2⁻⁸·max|dx|; measured: 1 of 63936
elements at two steps of its own value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theanompi_tpu.ops.pallas_lrn as pallas_lrn
from theanompi_tpu.ops import layers as JL
from theanompi_tpu_torch.ops import layers as L
from theanompi_tpu_torch.ops.lrn import (
    lrn, lrn_bwd, lrn_bwd_plain, lrn_fwd, lrn_fwd_plain,
)

SHAPE = (2, 9, 37, 96)
HYPER = dict(alpha=1e-4, beta=0.75, k=1.0)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2.0 ** -7, atol=1e-6)}


def _inputs(dtype_name, seed=0):
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(*SHAPE), 0).astype(np.float32) * 4.0
    dy = rng.randn(*SHAPE).astype(np.float32)
    jd = jnp.dtype(dtype_name)
    td = getattr(torch, dtype_name)
    return ((jnp.asarray(x).astype(jd), jnp.asarray(dy).astype(jd)),
            (torch.tensor(x).to(td), torch.tensor(dy).to(td)))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [3, 4, 5])
def test_lrn_matches_reference_pallas_kernel(size, dtype_name, monkeypatch):
    calls = []
    real = pallas_lrn._rowblock_call

    def spy(*a, **kw):
        calls.append(a[0].__name__)
        return real(*a, **kw)

    monkeypatch.setattr(pallas_lrn, "_rowblock_call", spy)
    (xj, dyj), (xt, dyt) = _inputs(dtype_name)
    y_ref, vjp = jax.vjp(lambda a: pallas_lrn.lrn(a, size, **HYPER), xj)
    (dx_ref,) = vjp(dyj)
    assert "_fwd_kernel" in calls and "_bwd_kernel" in calls

    xt = xt.clone().requires_grad_()
    y = lrn(xt, size, **HYPER)
    y.backward(dyt)
    assert y.dtype == xt.dtype and xt.grad.dtype == xt.dtype
    np.testing.assert_allclose(_np(y), _np(y_ref), **TOL[dtype_name])
    np.testing.assert_allclose(_np(xt.grad), _np(dx_ref), **TOL[dtype_name])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_lrn_layer_xla_path_matches_reference_band_path(dtype_name):
    (xj, dyj), (xt, dyt) = _inputs(dtype_name, seed=1)
    ref = JL.LRN(5, impl="xla")
    y_ref, vjp = jax.vjp(lambda a: ref.apply({}, {}, a)[0], xj)
    (dx_ref,) = vjp(dyj)
    xt = xt.clone().requires_grad_()
    y = L.LRN(5, impl="xla")(xt)
    y.backward(dyt)
    np.testing.assert_allclose(_np(y), _np(y_ref), **TOL[dtype_name])
    tol = dict(TOL[dtype_name])
    if dtype_name == "bfloat16":
        tol["atol"] = 2.0 ** -8 * float(np.abs(_np(dx_ref)).max())
    np.testing.assert_allclose(_np(xt.grad), _np(dx_ref), **tol)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    _, (xt, dyt) = _inputs("float32", seed=2)
    before = (lrn_fwd.launches, lrn_bwd.launches)
    assert torch.equal(lrn_fwd(xt, 4), lrn_fwd_plain(xt, 4))
    assert torch.equal(lrn_bwd(xt, dyt, 4), lrn_bwd_plain(xt, dyt, 4))
    assert (lrn_fwd.launches, lrn_bwd.launches) == before


def test_even_window_backward_uses_the_reverse_window():
    """For an even size the reverse window differs from the forward one:
    the plain backward must equal autograd through the plain forward."""
    _, (xt, dyt) = _inputs("float32", seed=3)
    xg = xt.clone().requires_grad_()
    lrn_fwd_plain(xg, 4).backward(dyt)
    np.testing.assert_allclose(lrn_bwd_plain(xt, dyt, 4).numpy(),
                               xg.grad.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["window", "shift"])
def test_unported_lrn_settings_raise(impl):
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        L.LRN(impl=impl)
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        L.LRN(impl="pallas", remat=True)

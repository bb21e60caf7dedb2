"""The port's max-pool backward (``theanompi_tpu_torch.ops.pool``; its
plain version on the CPU) against the reference's Pallas kernel
(``theanompi_tpu.ops.pallas_pool.maxpool_pallas``, interpret mode).

Inputs: tie-free (distinct values), all-tied (a constant plane: every
window ties on all its taps) and post-ReLU (whole windows of zeros),
windows 3/2 and 2/2, fp32 and bf16.  The cotangent of a window is split
equally across its tied maxima on both sides.  Tolerances: fp32
rtol = atol = 1e-6 (the same shares added in the same order; measured
exact); bf16 exact: both sides work in fp32 and round dx once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theanompi_tpu.ops.pallas_pool as pallas_pool
from theanompi_tpu_torch.ops import layers as L
from theanompi_tpu_torch.ops.pool import (
    maxpool_bwd, maxpool_bwd_plain, maxpool_fwd, maxpool_pallas,
)

SHAPE = (3, 15, 13, 8)
TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
       "bfloat16": dict(rtol=0, atol=0)}


def _x(kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "tie_free":
        n = int(np.prod(SHAPE))
        return (rng.permutation(n).reshape(SHAPE) / 64.0).astype(np.float32)
    if kind == "all_tied":
        return np.full(SHAPE, 0.75, np.float32)
    return np.maximum(rng.randn(*SHAPE), 0).astype(np.float32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,stride", [(3, 2), (2, 2)])
@pytest.mark.parametrize("kind", ["tie_free", "all_tied", "post_relu"])
def test_pool_backward_matches_reference_pallas_kernel(kind, window, stride,
                                                       dtype_name,
                                                       monkeypatch):
    calls = []
    real = pallas_pool.maxpool_bwd

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(pallas_pool, "maxpool_bwd", spy)
    x = _x(kind)
    jd, td = jnp.dtype(dtype_name), getattr(torch, dtype_name)
    win, st = (window, window), (stride, stride)
    xj = jnp.asarray(x).astype(jd)
    y_ref, vjp = jax.vjp(
        lambda a: pallas_pool.maxpool_pallas(a, win, st, "VALID"), xj)
    dy = np.random.RandomState(1).randn(*y_ref.shape).astype(np.float32)
    (dx_ref,) = vjp(jnp.asarray(dy).astype(jd))
    assert calls, "the reference's Pallas backward did not run"

    xt = torch.tensor(x).to(td).requires_grad_()
    y = maxpool_pallas(xt, window, stride)
    y.backward(torch.tensor(dy).to(td))
    np.testing.assert_array_equal(_np(y), _np(y_ref))
    np.testing.assert_allclose(_np(xt.grad), _np(dx_ref), **TOL[dtype_name])
    if kind == "all_tied" and dtype_name == "float32":
        # equal split conserves each window's cotangent mass
        np.testing.assert_allclose(float(xt.grad.sum()), float(dy.sum()),
                                   rtol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x = torch.tensor(_x("post_relu", seed=2))
    y = maxpool_fwd(x, 3, 2)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    before = maxpool_bwd.launches
    assert torch.equal(maxpool_bwd(x, y, dy, 3, 2),
                       maxpool_bwd_plain(x, y, dy, 3, 2))
    assert maxpool_bwd.launches == before


def test_pool_forward_is_nhwc_contiguous_and_same_padding_is_refused():
    x = torch.tensor(_x("tie_free"))
    y = maxpool_fwd(x, 3, 2)
    assert y.shape == (3, 7, 6, 8) and y.is_contiguous()
    with pytest.raises(ValueError, match="VALID"):
        maxpool_pallas(x, 3, 2, "SAME")
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        L.MaxPool(3, 2, grad_impl="mask")

"""The port's flash attention (``theanompi_tpu_torch.ops.flash``; its
plain versions on the CPU) against the reference's Pallas kernels
(``theanompi_tpu.ops.pallas_flash``, interpret mode on the CPU, as
``tests/test_flash.py`` runs them).

Inputs are made from a seed with numpy: q, k, v of shape (2, T, 2, 16)
for T in {8, 64, 96}, causal and full, fp32 and bf16.  The reference
runs with its default 128-row blocks (one block at these T) and, for
T = 64 and 96, with ``BLOCK_Q = BLOCK_K = 32`` set through
``monkeypatch`` (several blocks: the online softmax across blocks, the
causal block skips); the port's plain version takes the whole row at
once.  The backward is fed the same lse and Δ on both sides.

Tolerances: fp32 atol 2e-5 on out, lse, dq, dk and dv (both compute in
fp32; the softmax runs blockwise online in the reference and over the
whole row here, and the sums run in other orders).  bf16 outputs within
one bf16 step (rtol 2⁻⁷, atol 1e-5): the fp32 values before the final
rounding differ by ~1e-6, and the rounding may fall on either side;
fp16 (which the reference's kernels widen to fp32 like any float, and
the port's plain versions take on the CPU) the same form with fp16's
step (rtol 2⁻¹⁰, atol 1e-5); lse stays fp32 (atol 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theanompi_tpu.ops.pallas_flash as PF
from theanompi_tpu_torch.ops import flash as FL
from theanompi_tpu_torch.ops.attention import local_attention

B, H, D = 2, 2, 16
FP32 = dict(rtol=0.0, atol=2e-5)
TOL = {"float32": FP32, "bfloat16": dict(rtol=2.0 ** -7, atol=1e-5),
       "float16": dict(rtol=2.0 ** -10, atol=1e-5)}
DTYPES = ["float32", "bfloat16", "float16"]
CASES = [(8, None), (64, None), (64, 32), (96, None), (96, 32)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Leave the CPU to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _arrays(t, seed, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, t, H, D).astype(np.float32) for _ in range(n)]


def _jax(a, dtype_name):
    return jnp.asarray(a).astype(jnp.dtype(dtype_name))


def _torch(a, dtype_name):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype_name))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,block", CASES)
def test_forward_and_backward_rows_match_reference(t, block, causal,
                                                   dtype_name, monkeypatch):
    if block is not None:
        monkeypatch.setattr(PF, "BLOCK_Q", block)
        monkeypatch.setattr(PF, "BLOCK_K", block)
    q, k, v, do = _arrays(t, seed=t + 7 * int(causal))
    jq, jk, jv, jdo = (_jax(a, dtype_name) for a in (q, k, v, do))
    tq, tk, tv, tdo = (_torch(a, dtype_name) for a in (q, k, v, do))
    tol = TOL[dtype_name]

    out_ref, lse_ref = PF.flash_forward_with_lse(jq, jk, jv, causal)
    out, lse = FL.flash_forward_with_lse(tq, tk, tv, causal)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, H, t)
    _close(out, out_ref, tol, "out")
    _close(lse, lse_ref, FP32, "lse")

    scale = PF.resolve_scale(None, D)
    assert FL.resolve_scale(None, D) == scale
    jrows = [PF.to_rows(a) for a in (jq, jk, jv, jdo)]
    lse_rows = np.array(lse_ref).reshape(B * H, t)
    delta = np.sum(_np(PF.to_rows(jdo)) * _np(PF.to_rows(out_ref)), axis=-1)
    want = PF.flash_backward_rows(*jrows, jnp.asarray(lse_rows),
                                  jnp.asarray(delta), causal, scale)
    trows = [FL.to_rows(a) for a in (tq, tk, tv, tdo)]
    got = FL.flash_backward_rows(*trows, torch.from_numpy(lse_rows),
                                 torch.from_numpy(delta), causal, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tq.dtype
        _close(g, w, tol, name)


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_reference_vjp(causal, dtype_name, monkeypatch):
    """``flash_attention``'s autograd backward (Δ computed from the
    saved out) against ``jax.vjp`` of the reference's custom_vjp, over
    several 32-row blocks."""
    monkeypatch.setattr(PF, "BLOCK_Q", 32)
    monkeypatch.setattr(PF, "BLOCK_K", 32)
    q, k, v, ct = _arrays(96, seed=11 + int(causal))
    jargs = [_jax(a, dtype_name) for a in (q, k, v)]
    out_ref, vjp = jax.vjp(
        lambda a, b, c: PF.flash_attention(a, b, c, causal), *jargs)
    grads_ref = vjp(_jax(ct, dtype_name))
    targs = [_torch(a, dtype_name).requires_grad_() for a in (q, k, v)]
    out = FL.flash_attention(*targs, causal=causal)
    grads = torch.autograd.grad(out, targs, _torch(ct, dtype_name))
    tol = TOL[dtype_name]
    _close(out, out_ref, tol, "out")
    for name, g, w in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert g.dtype == targs[0].dtype and g.shape == targs[0].shape
        _close(g, w, tol, name)


def test_flash_equals_plain_attention_in_fp32():
    """In fp32 the flash path and the plain ``local_attention`` compute
    one function; ``attn_impl`` dispatches to it."""
    q, k, v, ct = (torch.from_numpy(a) for a in _arrays(40, seed=3))
    for a in (q, k, v):
        a.requires_grad_()
    for causal in (False, True):
        o1 = local_attention(q, k, v, causal=causal, attn_impl="flash")
        o2 = local_attention(q, k, v, causal=causal)
        torch.testing.assert_close(o1, o2, rtol=0, atol=2e-6)
        g1 = torch.autograd.grad(o1, (q, k, v), ct)
        g2 = torch.autograd.grad(o2, (q, k, v), ct)
        for a, b in zip(g1, g2):
            torch.testing.assert_close(a, b, rtol=0, atol=2e-6)


def test_bf16_probabilities_stay_fp32():
    """The flash path multiplies V by fp32 probabilities (as the Pallas
    kernel); the plain path rounds them to bf16 first (as
    ``full_attention``), so the two differ at bf16 by design."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _arrays(64, 5, 3))
    flash = FL.flash_attention(q, k, v, causal=True).float()
    plain = local_attention(q, k, v, causal=True).float()
    qf, kf, vf = (a.float() for a in (q, k, v))
    exact = local_attention(qf, kf, vf, causal=True)
    assert (flash - exact).abs().max() < (plain - exact).abs().max()


WIDE_D = 160  # above the CUDA kernels' 128: the plain versions take it


def _wide(t, seed, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, t, 2, WIDE_D).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_wide_head_rows_match_reference(causal, dtype_name):
    """D = 160: forward (out, lse) and the backward rows against the
    Pallas kernels in interpret mode, as at D = 16."""
    q, k, v, do = _wide(40, seed=21 + int(causal))
    jq, jk, jv, jdo = (_jax(a, dtype_name) for a in (q, k, v, do))
    tq, tk, tv, tdo = (_torch(a, dtype_name) for a in (q, k, v, do))
    tol = TOL[dtype_name]
    out_ref, lse_ref = PF.flash_forward_with_lse(jq, jk, jv, causal)
    out, lse = FL.flash_forward_with_lse(tq, tk, tv, causal)
    _close(out, out_ref, tol, "out")
    _close(lse, lse_ref, FP32, "lse")
    scale = PF.resolve_scale(None, WIDE_D)
    jrows = [PF.to_rows(a) for a in (jq, jk, jv, jdo)]
    lse_rows = np.array(lse_ref).reshape(2, 40)
    delta = np.sum(_np(PF.to_rows(jdo)) * _np(PF.to_rows(out_ref)), axis=-1)
    want = PF.flash_backward_rows(*jrows, jnp.asarray(lse_rows),
                                  jnp.asarray(delta), causal, scale)
    got = FL.flash_backward_rows(*[FL.to_rows(a) for a in (tq, tk, tv, tdo)],
                                 torch.from_numpy(lse_rows),
                                 torch.from_numpy(delta), causal, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, tol, name)


@pytest.mark.parametrize("causal", [False, True])
def test_wide_head_autograd_matches_reference_vjp(causal):
    q, k, v, ct = _wide(40, seed=31 + int(causal))
    jargs = [_jax(a, "float32") for a in (q, k, v)]
    out_ref, vjp = jax.vjp(
        lambda a, b, c: PF.flash_attention(a, b, c, causal), *jargs)
    grads_ref = vjp(_jax(ct, "float32"))
    targs = [_torch(a, "float32").requires_grad_() for a in (q, k, v)]
    out = FL.flash_attention(*targs, causal=causal)
    grads = torch.autograd.grad(out, targs, _torch(ct, "float32"))
    _close(out, out_ref, FP32, "out")
    for name, g, w in zip(("dq", "dk", "dv"), grads, grads_ref):
        _close(g, w, FP32, name)


def test_invalid_operands_raise():
    q = torch.zeros(2, 8, 2, 16)
    # the CPU takes any D; the CUDA route refuses D > 128 before a launch
    assert FL.flash_attention(*(torch.zeros(1, 8, 1, 129),) * 3).shape == (
        1, 8, 1, 129)
    with pytest.raises(ValueError, match="D <= 128.*ROADMAP B4"):
        FL._check_kernel_head_dim("flash_fwd", torch.zeros(1, 8, 129))
    FL._check_kernel_head_dim("flash_fwd", torch.zeros(1, 8, 128))
    with pytest.raises(ValueError, match="D >= 1"):
        FL.flash_fwd(*(torch.zeros(1, 8, 0),) * 3, True, 1.0)
    # the CPU computes fp16, as the reference's kernels widen any float;
    # the CUDA route refuses it before a launch, naming ROADMAP B4
    out = FL.flash_attention(q.half(), q.half(), q.half())
    assert out.dtype == torch.float16 and out.shape == q.shape
    with pytest.raises(ValueError, match="float16.*ROADMAP B4"):
        FL._check_kernel_dtype("flash_fwd", FL.to_rows(q.half()))
    FL._check_kernel_dtype("flash_fwd", FL.to_rows(q.bfloat16()))
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        FL.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="must match q"):
        FL.flash_attention(q, torch.zeros(2, 9, 2, 16), q)
    with pytest.raises(ValueError, match="lse and delta"):
        rows = FL.to_rows(q)
        FL.flash_dq(rows, rows, rows, rows, torch.zeros(4, 8),
                    torch.zeros(4, 7), True, 0.25)
    with pytest.raises(ValueError, match="no explicit mask"):
        local_attention(q, q, q, mask=torch.ones(2, 8, 8, dtype=torch.bool),
                        attn_impl="flash")
    with pytest.raises(ValueError, match="attn_impl"):
        local_attention(q, q, q, attn_impl="pallas")


def test_cpu_tensors_take_the_plain_versions_without_launching():
    before = (FL.flash_fwd.launches, FL.flash_dq.launches,
              FL.flash_dkv.launches)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _arrays(8, 1, 3))
    FL.flash_attention(q, k, v, causal=True).sum().backward()
    assert (FL.flash_fwd.launches, FL.flash_dq.launches,
            FL.flash_dkv.launches) == before
    with pytest.raises(ValueError, match="runs on cuda"):
        FL.flash_fwd(*(torch.zeros(1, 8, 4, device="meta"),) * 3, True, 0.5)

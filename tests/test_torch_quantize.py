"""The port's block quantizers (``theanompi_tpu_torch.parallel.quantize``)
against the reference's, on the CPU, where the wrappers take the plain
versions (the CUDA kernels are held to those on the card by
``chip_smoke.py``).

Tolerances, and why:

- RN int8 and fp16 against the reference's XLA path
  (``quantize_blocks``, ``quantize_blocks_fp16``): exact, payload and
  scales.  Both divide ``amax / cap`` and ``x / safe`` as IEEE
  divisions and round half to even.
- The same against the Pallas kernels in interpret mode: scales within
  one ulp, because interpret mode multiplies by ``fp32(1/127)`` (XLA:CPU
  rewrites the constant divide); payloads equal where the scales are
  equal and within 1 elsewhere.  fp16's cap, 256, is a power of two, so
  there both are exact.
- SR against ``pallas_quantize_blocks(x, key)`` with the key's seed
  word ``jax.random.bits(key, (1, 1), uint32)`` injected: payload exact,
  scales within one ulp.  The counter hash against ``_hash_uniform``:
  exact.
- Dequantize: exact (one fp32 product per element on both sides).
- Statistics (the reference's own oracles): the mean of 400 SR draws
  within 0.02 of 0.30 where round-to-nearest is stuck 0.30 away, and
  every SR value within one quantum of its input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel import quantize as R
from theanompi_tpu_torch.parallel import quantize as Q


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Leave the CPU to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _blocks(rows, seed, lead=None):
    """Gradient-like blocks: normal values, block magnitudes over six
    decades, row 0 all zero."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, Q.BLOCK) * 10.0 ** rng.uniform(-6, 1, (rows, 1))
    x[0] = 0.0
    x = x.astype(np.float32)
    return x.reshape(*lead, Q.BLOCK) if lead else x


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _ulps(a, b):
    return np.abs(_np(a).view(np.int32).astype(np.int64)
                  - _np(b).view(np.int32).astype(np.int64))


def _seed_word(key):
    return int(np.asarray(jax.random.bits(key, (1, 1), jnp.uint32))[0, 0])


# row counts that are and are not multiples of the TPU's 32-row tile
SHAPES = [(1,), (37,), (3, 5), (2, 64)]


@pytest.mark.parametrize("lead", SHAPES, ids=str)
def test_int8_rn_matches_xla_path_exactly(lead):
    rows = int(np.prod(lead))
    x = _blocks(rows, 1, lead)
    q, s = Q.quantize_int8(torch.from_numpy(x))
    rq, rs = R.quantize_blocks(x)
    assert q.dtype == torch.int8 and q.shape == x.shape
    assert s.shape == x.shape[:-1]
    np.testing.assert_array_equal(_np(q), _np(rq))
    np.testing.assert_array_equal(_np(s), _np(rs))


@pytest.mark.parametrize("lead", SHAPES, ids=str)
def test_fp16_matches_xla_path_exactly(lead):
    rows = int(np.prod(lead))
    x = _blocks(rows, 2, lead)
    q, s = Q.quantize_fp16(torch.from_numpy(x))
    rq, rs = R.quantize_blocks_fp16(x)
    assert q.dtype == torch.float16
    np.testing.assert_array_equal(_np(q), _np(rq))
    np.testing.assert_array_equal(_np(s), _np(rs))


@pytest.mark.parametrize("seed", [3, 4])
def test_int8_rn_matches_pallas_kernel_within_one_ulp_of_scale(seed):
    x = _blocks(64, seed)  # 2 Pallas tiles
    q, s = Q.quantize_int8(torch.from_numpy(x))
    pq, ps = R.pallas_quantize_blocks(x)
    ulps = _ulps(s, ps)
    assert ulps.max() <= 1
    same = ulps == 0
    np.testing.assert_array_equal(_np(q)[same], _np(pq)[same])
    assert np.abs(_np(q).astype(int) - _np(pq).astype(int)).max() <= 1


def test_fp16_matches_pallas_kernel_exactly():
    x = _blocks(64, 5)
    q, s = Q.quantize_fp16(torch.from_numpy(x))
    pq, ps = R.pallas_quantize_blocks_fp16(x)
    np.testing.assert_array_equal(_np(q), _np(pq))
    np.testing.assert_array_equal(_np(s), _np(ps))


@pytest.mark.parametrize("key_seed", [0, 1, 7])
def test_sr_matches_pallas_kernel_with_the_injected_seed_word(key_seed):
    x = _blocks(64, 10 + key_seed, (2, 32))
    key = jax.random.PRNGKey(key_seed)
    q, s = Q.quantize_int8_sr(torch.from_numpy(x), _seed_word(key))
    pq, ps = R.pallas_quantize_blocks(x, key)
    np.testing.assert_array_equal(_np(q), _np(pq))
    assert _ulps(s, ps).max() <= 1


def test_hash_matches_reference_hash_exactly():
    from theanompi_tpu.parallel.quantize import _hash_uniform

    rng = np.random.RandomState(8)
    c = rng.randint(0, 2 ** 32, size=4096, dtype=np.uint64).astype(np.uint32)
    c[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    got = Q.hash_uniform(torch.from_numpy(c.astype(np.int64)))
    want = np.asarray(jax.jit(_hash_uniform)(jnp.asarray(c)))
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("payload", ["int8", "fp16"])
def test_dequantize_matches_reference_exactly(payload):
    x = _blocks(64, 12)
    if payload == "int8":
        rq, rs = R.quantize_blocks(x)
    else:
        rq, rs = R.quantize_blocks_fp16(x)
    got = Q.dequantize(torch.from_numpy(np.array(rq)),
                       torch.from_numpy(np.array(rs)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), _np(R.dequantize_blocks(rq, rs)))
    np.testing.assert_array_equal(
        _np(got), _np(R.pallas_dequantize_blocks(rq, rs)))


def test_zero_blocks_quantize_to_zero_with_zero_scale():
    x = torch.zeros(4, Q.BLOCK)
    for q, s in (Q.quantize_int8(x), Q.quantize_int8_sr(x, 123),
                 Q.quantize_fp16(x)):
        assert int((q.float() != 0).sum()) == 0 and int((s != 0).sum()) == 0
        np.testing.assert_array_equal(_np(Q.dequantize(q, s)), _np(x))


def test_fp16_overflow_and_underflow_round_trip_like_reference():
    """The reference's hazard test: a plain fp16 cast overflows 1e6 and
    flushes 1e-8; the block scale round-trips both."""
    x = np.zeros((2, Q.BLOCK), np.float32)
    x[0] = 1e6
    x[1] = 1e-8
    q, s = Q.quantize_fp16(torch.from_numpy(x))
    back = _np(Q.dequantize(q, s))
    rq, rs = R.quantize_blocks_fp16(x)
    np.testing.assert_array_equal(back, _np(R.dequantize_blocks(rq, rs)))
    assert np.isfinite(back).all()
    np.testing.assert_allclose(back, x, rtol=1e-3)


def test_half_way_ties_round_to_even_like_reference():
    """amax 127 pins the scale at 1, so every other value is a tie
    k + 0.5: round half to even, as jnp.round does."""
    x = np.zeros((2, Q.BLOCK), np.float32)
    x[:, 0] = 127.0
    x[0, 1:] = np.arange(1, Q.BLOCK) % 64 - 31.5
    x[1, 1:] = -x[0, 1:]
    q, s = Q.quantize_int8(torch.from_numpy(x))
    rq, rs = R.quantize_blocks(x)
    np.testing.assert_array_equal(_np(s), [1.0, 1.0])
    np.testing.assert_array_equal(_np(q), _np(rq))
    np.testing.assert_array_equal(_np(q)[0, 1:5], [-30, -30, -28, -28])


def test_sr_is_unbiased_where_round_to_nearest_is_not():
    """The reference's oracle (``test_pallas_sr_kernel_is_unbiased``):
    the mean of many seeds converges to 0.30, RN stays at 0."""
    x = torch.full((32, Q.BLOCK), 0.30)
    x[:, 0] = 127.0
    acc = torch.zeros_like(x)
    n = 400
    for i in range(n):
        q, s = Q.quantize_int8_sr(x, _seed_word(jax.random.PRNGKey(i)))
        acc += Q.dequantize(q, s)
    sr_err = abs(float(acc[:, 1:].mean()) / n - 0.30)
    q, s = Q.quantize_int8(x)
    det_err = abs(float(Q.dequantize(q, s)[:, 1:].mean()) - 0.30)
    assert det_err > 0.25
    assert sr_err < 0.02


def test_sr_rounds_within_one_quantum_and_varies_with_the_seed():
    x = _blocks(32, 13) * 2.0
    xt = torch.from_numpy(x)
    q0, s0 = Q.quantize_int8_sr(xt, 1)
    back = _np(Q.dequantize(q0, s0))
    assert (np.abs(back - x) < _np(s0)[:, None] + 1e-7).all()
    q0b, _ = Q.quantize_int8_sr(xt, 1)
    q1, _ = Q.quantize_int8_sr(xt, 2)
    assert torch.equal(q0, q0b) and not torch.equal(q0, q1)


def test_cpu_tensors_take_the_plain_versions_without_launching():
    before = Q.launches()
    x = torch.from_numpy(_blocks(8, 14))
    q, s = Q.quantize_int8(x)
    Q.dequantize(q, s)
    Q.quantize_int8_sr(x, 5)
    Q.dequantize(*Q.quantize_fp16(x))
    assert Q.launches() == before


@pytest.mark.parametrize("bad", [
    torch.zeros(4, 128),
    torch.zeros(4, Q.BLOCK, dtype=torch.float64),
    torch.zeros(Q.BLOCK, dtype=torch.bfloat16),
], ids=["width", "float64", "bfloat16"])
def test_bad_inputs_raise(bad):
    with pytest.raises(ValueError, match="float32"):
        Q.quantize_int8(bad)
    with pytest.raises(ValueError, match="float32"):
        Q.quantize_fp16(bad)


def test_bad_payload_and_device_raise():
    q, s = Q.quantize_int8(torch.ones(2, Q.BLOCK))
    with pytest.raises(ValueError, match="payload"):
        Q.dequantize(q.float(), s)
    with pytest.raises(ValueError, match="scales"):
        Q.dequantize(q, s[:1])
    with pytest.raises(ValueError, match="runs on cuda"):
        Q.quantize_int8(torch.ones(2, Q.BLOCK, device="meta"))

"""Leg 2 of the port's ``int8`` and ``fp16s`` block wires in one call
(``theanompi_tpu_torch.parallel.quantize.dequant_sum_quantize_int8``
and ``dequant_sum_quantize_fp16``, which ``exchanger.wire_leg2`` runs)
on the CPU, where both wrappers take their plain versions (the CUDA
kernels are held to those on the card by ``chip_smoke.py``).  The
gathered shards are built here from every rank's leg-1 payload: the RN
int8 or fp16 quantization of gradient-like blocks, with a zero block, a
block whose sum lands on half-way ties, and (fp16) a block of tiny
magnitude whose quotients reach fp16's subnormals and underflow.

Tolerances, and why:

- Each fused plain leg 2 against the three-call composition
  ``quantize_*_plain(dequantize_plain(q_t, s_t).sum(dim=0))``: exact.
  Torch's CPU ``sum(dim=0)`` adds the ranks in ascending order, which
  the plain version writes out (and the kernel follows); the test
  checks that order at worlds 2, 3 and 4.
- The same leg against the reference's chain in interpret mode,
  ``pallas_dequantize_blocks`` → ``jnp.sum(axis=0)`` →
  ``pallas_quantize_blocks`` (RN) or ``pallas_quantize_blocks_fp16``,
  as ``tests/test_torch_quantize.py`` holds the single kernels: int8
  scales within one ulp (interpret mode multiplies by ``fp32(1/127)``),
  payload equal where the scales are equal and within one quantum
  elsewhere; fp16 exact (its cap, 256, is a power of two).  XLA:CPU's
  ``jnp.sum`` over the rank axis adds in ascending order at these
  worlds; were it to order otherwise, the fp16 comparison would show it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel import quantize as R
from theanompi_tpu_torch.parallel import quantize as Q

WORLDS = (2, 3, 4)
PAYLOADS = ("int8", "fp16")
# payload → (fused wrapper, its plain version, leg-1 quantizer)
LEGS = {
    "int8": (Q.dequant_sum_quantize_int8, Q.dequant_sum_quantize_int8_plain,
             Q.quantize_int8_plain),
    "fp16": (Q.dequant_sum_quantize_fp16, Q.dequant_sum_quantize_fp16_plain,
             Q.quantize_fp16_plain),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Leave the CPU to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ulps(a, b):
    return np.abs(np.asarray(a).view(np.int32).astype(np.int64)
                  - np.asarray(b).view(np.int32).astype(np.int64))


def _ties(payload, q_t, s_t):
    """Block 1 of ranks 0 and 1 set so that the sum lands on half-way
    ties of the output's rounding; every other rank's block 1 zero.
    int8: rank 0 k − 128 at scale 1, rank 1 ones at scale 1/2 (column 0
    126 + 1 pins the amax, so the scale, at 1); fp16: rank 0 ±(1 +
    k·2⁻¹⁰) at scale 1, rank 1 ±1 at scale 2⁻¹¹ (column 0 256 + 0 pins
    the scale at 1), each sum half-way between two fp16 neighbours."""
    q_t[:, 1], s_t[:, 1] = 0, 0.0
    k = torch.arange(Q.BLOCK)
    if payload == "int8":
        q_t[0, 1] = (k - 128).clamp(-127, 126)
        q_t[0, 1, 0] = 126
        q_t[1, 1] = 1
        q_t[1, 1, 0] = 2
        s_t[0, 1], s_t[1, 1] = 1.0, 0.5
    else:
        sign = torch.where(k % 3 == 0, -1.0, 1.0)
        q_t[0, 1] = (sign * (1.0 + k / 1024.0)).to(torch.float16)
        q_t[0, 1, 0] = 256.0
        q_t[1, 1] = sign.to(torch.float16)
        q_t[1, 1, 0] = 0.0
        s_t[0, 1], s_t[1, 1] = 1.0, 2.0 ** -11


def _shards(payload, world, nb, seed):
    """Gathered leg-1 shards ``(q_t, s_t)`` of ``payload``: every rank's
    leg-1 quantization of gradient-like blocks, block 0 zero on every
    rank (a zero sum); where nb > 1 block 1 of half-way ties; where
    nb > 2 and fp16, block 2 of rank 0 at amax 1e-20 with values down
    to 40 binades below it, all normal in fp32 (quotients in fp16's
    subnormals and below), the other ranks' block 2 zero."""
    rng = np.random.RandomState(seed)
    x = rng.randn(world, nb, Q.BLOCK) * 10.0 ** rng.uniform(-6, 1,
                                                            (world, nb, 1))
    x = x.astype(np.float32)
    x[:, 0] = 0.0
    if payload == "fp16" and nb > 2:
        x[:, 2] = 0.0
        e = -(np.arange(Q.BLOCK) % 41)
        x[0, 2] = (1e-20 * np.exp2(e.astype(np.float64))
                   * rng.choice([-1.0, 1.0], Q.BLOCK)).astype(np.float32)
    q_t, s_t = LEGS[payload][2](torch.from_numpy(x))
    if nb > 1:
        _ties(payload, q_t, s_t)
    return q_t, s_t


@pytest.mark.parametrize("nb", [1, 2, 32])
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("payload", PAYLOADS)
def test_fused_leg2_equals_the_three_call_composition(payload, world, nb):
    fused, plain, quant = LEGS[payload]
    q_t, s_t = _shards(payload, world, nb, seed=world * 10 + nb)
    d = Q.dequantize_plain(q_t, s_t)
    ascending = d[0]
    for p in range(1, world):
        ascending = ascending + d[p]
    assert torch.equal(d.sum(dim=0), ascending)
    want_q, want_s = quant(d.sum(dim=0))
    before = Q.launches()
    for got_q, got_s in (fused(q_t, s_t), plain(q_t, s_t)):
        assert got_q.dtype == q_t.dtype and got_q.shape == (nb, Q.BLOCK)
        assert got_s.dtype == torch.float32 and got_s.shape == (nb,)
        assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)
    assert Q.launches() == before  # the CPU route launches nothing
    assert float(want_s[0]) == 0.0 and not want_q[0].any()
    if nb > 1:  # the tie block: scale 1, every sum half-way, to even
        assert float(want_s[1]) == 1.0
        sums = ascending[1]
        if payload == "int8":
            ties = sums != sums.round()
            assert int(ties.sum()) == Q.BLOCK - 1
            assert not (want_q[1][ties].int() % 2).any()
        else:
            ties = sums.half().float() != sums
            assert int(ties.sum()) == Q.BLOCK - 1
            assert not (want_q[1][ties].view(torch.int16) & 1).any()
    if payload == "fp16" and nb > 2:  # fp16 subnormals and underflow
        small = want_q[2].float().abs()
        assert float(want_s[2]) < 1e-22
        assert int(((small > 0) & (small < 2.0 ** -14)).sum()) > 0
        assert int((small == 0).sum()) > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("payload", PAYLOADS)
def test_fused_leg2_matches_the_pallas_chain(payload, world):
    """The reference's leg 2 of the ``pallas_int8`` / ``pallas_fp16s``
    wire in interpret mode (32-row tiles: nb 32)."""
    q_t, s_t = _shards(payload, world, 32, seed=100 + world)
    mine = jnp.sum(R.pallas_dequantize_blocks(jnp.asarray(q_t.numpy()),
                                              jnp.asarray(s_t.numpy())),
                   axis=0)
    q2, s2 = LEGS[payload][0](q_t, s_t)
    if payload == "fp16":
        pq, ps = R.pallas_quantize_blocks_fp16(mine)
        np.testing.assert_array_equal(q2.numpy(), np.asarray(pq))
        np.testing.assert_array_equal(s2.numpy(), np.asarray(ps))
        return
    pq, ps = R.pallas_quantize_blocks(mine)
    ulps = _ulps(s2.numpy(), np.asarray(ps))
    assert ulps.max() <= 1
    same = ulps == 0
    np.testing.assert_array_equal(q2.numpy()[same], np.asarray(pq)[same])
    assert np.abs(q2.numpy().astype(int)
                  - np.asarray(pq).astype(int)).max() <= 1


@pytest.mark.parametrize("bad", ["payload", "2-D", "scales", "float"])
@pytest.mark.parametrize("payload", PAYLOADS)
def test_fused_leg2_refuses_bad_shards(payload, bad):
    q_t, s_t = _shards(payload, 2, 4, seed=5)
    if bad == "payload":  # the other wire's payload
        q_t = q_t.to(torch.float16 if payload == "int8" else torch.int8)
    elif bad == "2-D":
        q_t, s_t = q_t[0], s_t[0]
    elif bad == "scales":
        s_t = s_t[:, :3]
    else:
        q_t = q_t.float()
    for call in LEGS[payload][:2]:
        with pytest.raises(ValueError, match="shards"):
            call(q_t, s_t)

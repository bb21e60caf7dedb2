"""Leg 2 and the last dequantize of the port's block wire
(``theanompi_tpu_torch.parallel.exchanger.wire_leg2``,
``parallel.quantize.dequant_sum_quantize_int8_sr`` and ``dequantize``
with ``divisor`` and ``n``, which ``_wire_from_packed`` and
``_img_from_packed`` call) on the CPU, where every wrapper takes its
plain version (the CUDA kernels are held to those on the card by
``chip_smoke.py``), without a process group: the gathered shards are
built here from every rank's leg-1 payload.

Tolerances, and why:

- The fused leg 2's plain version against the three-call composition
  ``quantize_int8_sr_plain(dequantize_plain(q_t, s_t).sum(dim=0),
  seed)``: exact.  Torch's CPU ``sum(dim=0)`` adds the ranks in
  ascending order, which the plain version writes out (and the kernel
  follows); the test checks that order at worlds 2, 3 and 4.
- The same chain against the reference's ``pallas_dequantize_blocks``
  → ``jnp.sum(axis=0)`` → ``pallas_quantize_blocks`` in interpret mode
  with the key's seed word ``jax.random.bits(key, (1, 1), uint32)``
  injected: payload exact, scales within one ulp (interpret mode
  multiplies by ``fp32(1/127)``), as ``tests/test_torch_quantize.py``
  holds the SR kernel.
- The dequantize with the mean folded in against the parent's
  ``dequantize(q, s).view(-1)[:n] / world``: exact at every world (the
  CPU divides by a Python number as an IEEE division).  At worlds 2 and
  4 it also equals the product with ``1/world`` (what torch on the card
  computes for a division by a Python number): halving and quartering
  are exact.  At world 3 the two can differ by one ulp; the division
  is the correctly rounded one.
- ``wire_leg2`` and the last dequantize against the parent's three-call
  leg 2 and its dequantize-then-divide, for every block strategy: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel import quantize as R
from theanompi_tpu_torch.parallel import quantize as Q
from theanompi_tpu_torch.parallel.exchanger import (
    block_wire_kernels, blocks_per_shard, wire_leg2,
)

BLOCK_STRATEGIES = ("int8", "pallas_int8", "int8_sr", "pallas_int8_sr",
                    "fp16s", "pallas_fp16s")
WORLDS = (2, 3, 4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Leave the CPU to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _seed_word(key):
    return int(np.asarray(jax.random.bits(key, (1, 1), jnp.uint32))[0, 0])


def _ulps(a, b):
    return np.abs(np.asarray(a).view(np.int32).astype(np.int64)
                  - np.asarray(b).view(np.int32).astype(np.int64))


def _blocks(rows, rng):
    """Gradient-like fp32 blocks: normal values, block magnitudes over
    six decades."""
    x = rng.randn(rows, Q.BLOCK) * 10.0 ** rng.uniform(-6, 1, (rows, 1))
    return x.astype(np.float32)


def _shards(world, nb, seed):
    """Gathered leg-1 shards ``(q_t, s_t)``: every rank's SR payload of
    gradient-like blocks, block 0 zero on every rank (a zero sum), and,
    where nb > 1, block 1 summing to half-way ties at scale 1 (rank 0:
    k − 128 at scale 1, rank 1: ones at scale 1/2, column 0 126 + 1)."""
    rng = np.random.RandomState(seed)
    x = _blocks(world * nb, rng).reshape(world, nb, Q.BLOCK)
    x[:, 0] = 0.0
    q_t, s_t = Q.quantize_int8_sr_plain(torch.from_numpy(x), 1000 + seed)
    if nb > 1:
        q_t[:, 1], s_t[:, 1] = 0, 0.0
        q_t[0, 1] = (torch.arange(Q.BLOCK) - 128).clamp(-127, 126)
        q_t[0, 1, 0] = 126
        q_t[1, 1] = 1
        q_t[1, 1, 0] = 2
        s_t[0, 1], s_t[1, 1] = 1.0, 0.5
    return q_t, s_t


@pytest.mark.parametrize("nb", [1, 2, 32, 2048])
@pytest.mark.parametrize("world", WORLDS)
def test_fused_leg2_equals_the_three_call_composition(world, nb):
    q_t, s_t = _shards(world, nb, seed=world * 10 + nb)
    seed = 0x9E3779B9 + nb
    d = Q.dequantize_plain(q_t, s_t)
    ascending = d[0]
    for p in range(1, world):
        ascending = ascending + d[p]
    assert torch.equal(d.sum(dim=0), ascending)
    want_q, want_s = Q.quantize_int8_sr_plain(d.sum(dim=0), seed)
    before = Q.launches()
    for got_q, got_s in (Q.dequant_sum_quantize_int8_sr(q_t, s_t, seed),
                         Q.dequant_sum_quantize_int8_sr_plain(q_t, s_t,
                                                              seed)):
        assert got_q.dtype == torch.int8 and got_q.shape == (nb, Q.BLOCK)
        assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)
    assert Q.launches() == before
    if nb > 1:  # the tie block: scale 1, every value k + 0.5 or ±127
        assert float(want_s[1]) == 1.0 and float(want_s[0]) == 0.0
        assert int((want_q[0] != 0).sum()) == 0


@pytest.mark.parametrize("key_seed", [0, 1])
@pytest.mark.parametrize("world", WORLDS)
def test_leg2_matches_the_pallas_chain_with_the_injected_seed_word(
        world, key_seed):
    q_t, s_t = _shards(world, 32, seed=100 + world)
    key = jax.random.PRNGKey(key_seed)
    mine = jnp.sum(R.pallas_dequantize_blocks(jnp.asarray(q_t.numpy()),
                                              jnp.asarray(s_t.numpy())),
                   axis=0)
    pq, ps = R.pallas_quantize_blocks(mine, key)
    q2, s2 = Q.dequant_sum_quantize_int8_sr(q_t, s_t, _seed_word(key))
    np.testing.assert_array_equal(q2.numpy(), np.asarray(pq))
    assert _ulps(s2.numpy(), np.asarray(ps)).max() <= 1


def _payload(world, nb, payload, seed):
    x = torch.from_numpy(_blocks(world * nb, np.random.RandomState(seed))
                         .reshape(world, nb, Q.BLOCK))
    if payload == "int8":
        return Q.quantize_int8_sr_plain(x, seed)
    return Q.quantize_fp16_plain(x)


@pytest.mark.parametrize("payload", ["int8", "fp16"])
@pytest.mark.parametrize("world", WORLDS)
def test_folded_dequantize_is_the_parent_divide(world, payload):
    q, s = _payload(world, 48, payload, seed=world)
    for n in (q.numel(), q.numel() - 37, 1):
        got = Q.dequantize(q, s, world, n)
        old = Q.dequantize_plain(q, s).view(-1)[:n] / world
        assert got.shape == (n,) and torch.equal(got, old)
        np.testing.assert_array_equal(
            got.numpy(), Q.dequantize_plain(q, s).view(-1)[:n].numpy()
            / np.float32(world))
        by_reciprocal = Q.dequantize_plain(q, s).view(-1)[:n] * (1.0 / world)
        if world in (2, 4):
            assert torch.equal(got, by_reciprocal)
        else:
            assert _ulps(got.numpy(), by_reciprocal.numpy()).max() <= 1
    if world == 3:  # the IEEE quotient is not the reciprocal's product
        full = Q.dequantize_plain(q, s).view(-1)
        assert (full / 3 != full * (1.0 / 3)).any()
    assert torch.equal(Q.dequantize(q, s, n=q.numel() - 5),
                       Q.dequantize_plain(q, s).view(-1)[:q.numel() - 5])


def _gathered(strategy, world, n, seed):
    """Every rank's leg-1 pack of its own flat contribution, and what
    each rank holds after the all_to_all: ``(packs, shards, seeds)``."""
    rng = np.random.RandomState(seed)
    nb = blocks_per_shard(n, world, strategy)
    quant, _ = block_wire_kernels(strategy)
    seeds = [tuple(int(w) for w in rng.randint(0, 2 ** 32, 2,
                                               dtype=np.uint64))
             for _ in range(world)]
    packs = []
    for r in range(world):
        flat = np.zeros(world * nb * Q.BLOCK, np.float32)
        flat[:n] = rng.randn(n) * rng.uniform(0.1, 3.0)
        packs.append(quant(torch.from_numpy(flat).view(world, nb, Q.BLOCK),
                           seeds[r][0]))
    shards = [(torch.stack([packs[p][0][r] for p in range(world)]),
               torch.stack([packs[p][1][r] for p in range(world)]))
              for r in range(world)]
    return packs, shards, seeds


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("strategy", BLOCK_STRATEGIES)
def test_factored_legs_equal_the_parent_chain(strategy, world):
    """The parent's ``_wire_from_packed``: ``quant(dequant(q_t, s_t)
    .sum(dim=0), w2)``, all_gather, ``dequant(q_all, s_all).view(-1)
    [:n]``, then ``/ world`` in ``_flat_mean``; the error-feedback
    image ``dequant(q, s).view(-1)[:n]``."""
    quant, dequant = block_wire_kernels(strategy)
    n = world * 256 * 32 * 3 - 77  # pads in every strategy
    packs, shards, seeds = _gathered(strategy, world, n, seed=world)
    legs2 = []
    for r, (q_t, s_t) in enumerate(shards):
        got = wire_leg2(strategy, q_t, s_t, seeds[r][1])
        want = quant(dequant(q_t, s_t).sum(dim=0), seeds[r][1])
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        legs2.append(got)
    q_all = torch.stack([q2 for q2, _ in legs2])
    s_all = torch.stack([s2 for _, s2 in legs2])
    got = Q.dequantize(q_all, s_all, world, n)
    assert torch.equal(got, dequant(q_all, s_all).view(-1)[:n] / world)
    q, s = packs[0]
    assert torch.equal(Q.dequantize(q, s, n=n), dequant(q, s).view(-1)[:n])


@pytest.mark.parametrize("bad", ["float", "2-D", "scales"])
def test_fused_leg2_refuses_bad_shards(bad):
    q_t, s_t = _shards(2, 4, seed=5)
    if bad == "float":
        q_t = q_t.float()
    elif bad == "2-D":
        q_t, s_t = q_t[0], s_t[0]
    else:
        s_t = s_t[:, :3]
    with pytest.raises(ValueError, match="shards"):
        Q.dequant_sum_quantize_int8_sr(q_t, s_t, 1)


def test_dequantize_refuses_a_length_past_the_payload():
    q, s = _payload(2, 2, "int8", seed=6)
    with pytest.raises(ValueError, match="n="):
        Q.dequantize(q, s, 2, q.numel() + 1)
    assert Q.dequantize(q, s, 2, 0).shape == (0,)

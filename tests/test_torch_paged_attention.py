"""Paged decode attention in the PyTorch port against the reference.

The port's plain version (the CPU path of ``paged_decode_attention``,
and the reference the CUDA kernel is held to on the card) is compared
with the reference TPU kernel ``theanompi_tpu.ops.pallas_paged.
paged_decode_attention`` run in interpret mode, on inputs made with
numpy from a seed and handed to both.

Tolerances: fp32 pools rtol = atol = 1e-5 — both compute in fp32 and
differ only in summation order (one softmax over the whole image vs an
online softmax over blocks).  bf16 pools atol 2e-2 — both read the
same bf16 values, but the plain version (like the reference's XLA
path) rounds the probabilities to bf16 before the second product, the
TPU kernel does not.
"""

import numpy as np
import pytest
import torch

from theanompi_tpu.ops.pallas_paged import (
    paged_decode_attention as pallas_paged_decode_attention,
)
from theanompi_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)

S, H, HD, BS, NB, NT = 4, 4, 8, 4, 10, 5
TABLES = np.array(
    [[1, 3, 5, 0, 0], [2, 4, 6, 7, 0], [8, 9, 1, 2, 3], [5, 6, 7, 8, 9]],
    np.int32,
)
# length-0 lanes, lengths on a block boundary (the first row of a new
# block: 4, 8, 12), the last row of a block (3, 7, 11, 15), the whole
# table (19), and lanes whose later blocks are fully masked
LENGTHS = [
    [9, 14, 0, 19],
    [8, 4, 12, 0],
    [7, 11, 15, 3],
]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=0, atol=2e-2)}


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(S, H, HD).astype(np.float32)
    kp = rng.randn(NB * BS, H, HD).astype(np.float32)
    vp = rng.randn(NB * BS, H, HD).astype(np.float32)
    return q, kp, vp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(LENGTHS)))
def test_plain_matches_pallas_kernel_interpret(case, dtype):
    import jax.numpy as jnp

    q, kp, vp = _inputs(case)
    lengths = np.array(LENGTHS[case], np.int32)
    scale = HD ** -0.5
    tdt = getattr(torch, dtype)
    kp_t = torch.from_numpy(kp).to(tdt)
    vp_t = torch.from_numpy(vp).to(tdt)
    # hand the reference the identical pool values the port holds
    kp_j = jnp.asarray(kp_t.float().numpy()).astype(dtype)
    vp_j = jnp.asarray(vp_t.float().numpy()).astype(dtype)
    want = np.array(pallas_paged_decode_attention(
        jnp.asarray(q), kp_j, vp_j, jnp.asarray(TABLES),
        jnp.asarray(lengths), block_size=BS, scale=scale, interpret=True,
    ))
    got = paged_decode_attention_plain(
        torch.from_numpy(q), kp_t, vp_t, torch.from_numpy(TABLES),
        torch.from_numpy(lengths), block_size=BS, scale=scale,
    )
    assert got.dtype == torch.float32 and got.shape == (S, H, HD)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    q, kp, vp = _inputs(7)
    args = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(TABLES),
            torch.from_numpy(np.array(LENGTHS[0], np.int32)))
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args, block_size=BS)
    want = paged_decode_attention_plain(*args, block_size=BS)
    assert paged_decode_attention.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_raises_on_other_devices():
    """A device that is neither the card nor the CPU must raise, never
    compute (the meta device computes shapes only)."""
    q = torch.empty(S, H, HD, device="meta")
    kp = torch.empty(NB * BS, H, HD, device="meta")
    tables = torch.empty(S, NT, dtype=torch.int32, device="meta")
    lengths = torch.empty(S, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        paged_decode_attention(q, kp, kp, tables, lengths, block_size=BS)

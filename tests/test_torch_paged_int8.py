"""The port's int8 KV cache against the JAX reference, on the CPU.

- The int8 pool's attention: the port's plain version (the CPU path of
  ``paged_decode_attention`` with int8 pools, and what the CUDA kernel
  is held to on the card) against the reference's TPU kernel
  ``_paged_kernel_i8`` (``pallas_paged.paged_decode_attention`` with
  ``k_scale``/``v_scale``, interpret mode), on int8 pools and scales
  made by the reference's ``quantize_blocks`` from seeded numpy inputs.
  atol 1e-5: both dequantize in fp32 and differ only in summation order
  (a softmax over the whole image against an online one over blocks).
- The quantizer: ``quantize_rows`` against ``quantize_blocks`` over
  head_dim, eager and under ``jax.jit`` (as the reference's engine runs
  it, where XLA:CPU may multiply by fp32(1/127) in place of the IEEE
  division): scales within 1 ulp, payload equal where the scales are
  equal and within 1 elsewhere, dequantized values within one quantum.
- The engine: ``PagedServingEngine(kv_dtype='int8')`` against the
  reference's with ``kv_dtype='int8', paged_attn='pallas'`` on a
  one-device mesh (the model of ``test_torch_serving.py``).  After the
  same prefill chunks the pools agree: the K/V rows going in differ
  between the frameworks by fp32 summation order (the fp32 pool's rows
  agree to 1e-5 in ``test_torch_serving.py``), so scales agree to rtol
  1e-5 (measured: 13 ulps), payloads within 1 where scales differ and
  equal elsewhere, dequantized rows within one quantum + 1e-5.  Block 0,
  the trash block that pad lanes write in no fixed order, is not
  compared.  Logits atol 1e-4 (fp32, as the fp32 pool's test).
  Scheduler tokens equal the reference engine's greedy picks; a
  divergence would pass only where the reference's top-2 logit margin
  at that token is below 1e-3 (an int8 payload flip of one quantum,
  under the frameworks' fp32 differences, moves logits by less).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models.transformer import TransformerLM as JaxLM
from theanompi_tpu.ops.pallas_paged import (
    paged_decode_attention as pallas_paged_decode_attention,
)
from theanompi_tpu.parallel.quantize import quantize_blocks
from theanompi_tpu.runtime.mesh import make_mesh
from theanompi_tpu.serving import PagedServingEngine as JaxPaged
from theanompi_tpu_torch.convert import params_from_jax
from theanompi_tpu_torch.models.transformer import TransformerLM
from theanompi_tpu_torch.ops import paged_attention as PA
from theanompi_tpu_torch.parallel.quantize import (
    dequantize_rows,
    quantize_rows,
)
from theanompi_tpu_torch.serving import (
    ContinuousBatchingScheduler,
    PagedServingEngine,
    Request,
)

ARCH = dict(seq_len=64, vocab_size=32, d_model=32, n_heads=4, n_layers=2)
JAX_CFG = dict(ARCH, batch_size=2, n_synth_train=2, n_synth_val=1,
               comm_probe=False, print_freq=10_000)
GEOM = dict(n_slots=2, max_len=64, buckets=(8, 16, 64), block_size=8,
            prefill_chunk=16)
TIE_MARGIN = 1e-3

# (S, H, hd, bs, n_blocks, tables, lengths): the reference's own kernel
# case (tests/test_serving_spec.py, with its length-0 lane), and the
# serving geometry's block 32 / head_dim 64 with lengths on block edges
KERNEL_CASES = {
    "spec_case": (3, 4, 8, 4, 10,
                  [[1, 3, 5, 0, 0], [2, 4, 6, 7, 0], [8, 9, 1, 2, 3]],
                  [9, 14, 0]),
    "bs32_hd64": (5, 2, 64, 32, 9,
                  [[1, 2, 3, 4], [5, 6, 7, 8], [8, 7, 6, 5], [2, 4, 6, 8],
                   [3, 1, 0, 0]],
                  [0, 31, 32, 127, 63]),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Leave the CPU to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _quantized_pools(rng, rows, h, hd):
    out = []
    for _ in range(2):
        q, s = quantize_blocks(
            jnp.asarray(rng.randn(rows, h, hd).astype(np.float32)))
        out += [np.array(q), np.array(s)]
    return out  # kq, ks, vq, vs


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_i8_plain_matches_pallas_kernel_interpret(case):
    s_, h, hd, bs, nb, tables, lengths = KERNEL_CASES[case]
    rng = np.random.RandomState(len(case))
    q = rng.randn(s_, h, hd).astype(np.float32)
    kq, ks, vq, vs = _quantized_pools(rng, nb * bs, h, hd)
    tables = np.array(tables, np.int32)
    lengths = np.array(lengths, np.int32)
    want = np.array(pallas_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(tables), jnp.asarray(lengths), block_size=bs,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True,
    ))
    t = [torch.from_numpy(a) for a in (q, kq, vq, ks, vs, tables, lengths)]
    before = (PA.paged_decode_attention.launches,
              PA.paged_decode_attention_i8.launches)
    got = PA.paged_decode_attention(
        t[0], t[1], t[2], t[5], t[6], block_size=bs, k_scale=t[3],
        v_scale=t[4])
    assert got.dtype == torch.float32 and got.shape == (s_, h, hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    plain = PA.paged_decode_attention_i8_plain(
        t[0], t[1], t[2], t[3], t[4], t[5], t[6], block_size=bs)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert (PA.paged_decode_attention.launches,
            PA.paged_decode_attention_i8.launches) == before


def test_int8_pools_without_scales_raise():
    s_, h, hd, bs, nb, tables, lengths = KERNEL_CASES["spec_case"]
    q = torch.zeros(s_, h, hd)
    pool = torch.zeros(nb * bs, h, hd, dtype=torch.int8)
    args = (q, pool, pool, torch.tensor(tables, dtype=torch.int32),
            torch.tensor(lengths, dtype=torch.int32))
    with pytest.raises(ValueError, match="k_scale"):
        PA.paged_decode_attention(*args, block_size=bs)
    with pytest.raises(ValueError, match="k_scale"):
        PA.paged_decode_attention(
            *args, block_size=bs, k_scale=torch.ones(nb * bs, h))


def test_cuda_input_checks_refuse_what_the_kernels_do_not_take():
    """The checks the CUDA route runs before a launch (called here on
    CPU tensors, where the route itself takes the plain version)."""
    s_, h, bs, nb = 2, 2, 4, 3
    tables = torch.ones(s_, 2, dtype=torch.int32)
    lengths = torch.zeros(s_, dtype=torch.int32)
    wide = torch.zeros(nb * bs, h, 136)
    with pytest.raises(ValueError, match="ROADMAP B5"):
        PA._check_cuda_inputs(torch.zeros(s_, h, 136), wide, wide, tables,
                              lengths)
    pool = torch.zeros(nb * bs, h, 8, dtype=torch.int8)
    q = torch.zeros(s_, h, 8)
    with pytest.raises(ValueError, match="k_scale must be float32"):
        PA._check_cuda_inputs(q, pool, pool, tables, lengths,
                              torch.ones(nb * bs, h + 1),
                              torch.ones(nb * bs, h))
    with pytest.raises(TypeError, match="int8"):
        PA._check_cuda_inputs(q, pool, pool.float(), tables, lengths)
    PA._check_cuda_inputs(q, pool, pool, tables, lengths,
                          torch.ones(nb * bs, h), torch.ones(nb * bs, h))
    # a head of 136 on the CPU: the plain version takes it
    q136 = torch.randn(s_, h, 136)
    out = PA.paged_decode_attention(q136, wide, wide, tables, lengths,
                                    block_size=bs)
    assert out.shape == (s_, h, 136)


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------

def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _assert_quantized_close(q, s, q_ref, s_ref, max_ulps=1):
    """The quantizer criterion: scales within ``max_ulps`` ulps, payload
    equal where the scales are, within 1 where they are not, and the
    dequantized values within one quantum."""
    q, q_ref = q.astype(np.int64), q_ref.astype(np.int64)
    assert _ulps(s, s_ref).max() <= max_ulps
    same = (s == s_ref)[..., None] & np.ones(q.shape, bool)
    np.testing.assert_array_equal(q[same], q_ref[same])
    assert np.abs(q - q_ref).max() <= 1
    deq = q * s[..., None].astype(np.float64)
    deq_ref = q_ref * s_ref[..., None].astype(np.float64)
    assert (np.abs(deq - deq_ref) <= s_ref[..., None] * (1 + 1e-6)).all()


def _kv_rows(seed, shape=(64, 4, 64)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * rng.uniform(0.1, 10, shape[:-1])[..., None])
    x = x.astype(np.float32)
    x[3] = 0.0  # all-zero rows: scale 0, payload 0
    # exact half-way points: amax 127 gives scale 1 (round half to even)
    x[5, 0, :4] = [127.0, 2.5, -3.5, 0.5]
    x[5, 0, 4:] = 0.0
    return x


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("shape", [(64, 4, 64), (37, 2, 8), (9, 3, 136)])
def test_quantize_rows_matches_quantize_blocks_over_head_dim(shape, jit):
    x = _kv_rows(sum(shape), shape)
    fn = jax.jit(quantize_blocks) if jit else quantize_blocks
    q_ref, s_ref = (np.array(a) for a in fn(jnp.asarray(x)))
    q, s = quantize_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == x.shape and s.shape == x.shape[:-1]
    _assert_quantized_close(q.numpy(), s.numpy(), q_ref, s_ref)
    if not jit:  # the reference's source text, eagerly: bit for bit
        np.testing.assert_array_equal(s.numpy(), s_ref)
        np.testing.assert_array_equal(q.numpy(), q_ref)
    assert q.numpy()[3].max() == 0 and s.numpy()[3].max() == 0
    np.testing.assert_array_equal(q.numpy()[5, 0, :4], [127, 2, -4, 0])
    back = dequantize_rows(q, s).numpy()
    assert (np.abs(back - x) <= s.numpy()[..., None] * 0.5 + 1e-6).all()
    # bf16 rows go in widened to fp32, as the reference's .astype(fp32)
    qb, sb = quantize_rows(torch.from_numpy(x).bfloat16())
    qb_ref, sb_ref = quantize_blocks(
        jnp.asarray(torch.from_numpy(x).bfloat16().float().numpy()))
    np.testing.assert_array_equal(sb.numpy(), np.array(sb_ref))
    np.testing.assert_array_equal(qb.numpy(), np.array(qb_ref))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_model():
    return JaxLM(config=dict(JAX_CFG),
                 mesh=make_mesh(devices=jax.devices()[:1]))


@pytest.fixture(scope="module")
def model(jax_model):
    m = TransformerLM(ARCH, seed=1, device="cpu")
    m.load_state_dict(params_from_jax(
        [jax.tree.map(np.array, p) for p in jax_model.params]))
    return m


@pytest.fixture(scope="module")
def jax_engine(jax_model):
    eng = JaxPaged(jax_model, kv_dtype="int8", paged_attn="pallas", **GEOM)
    assert eng.paged_attn_effective == "pallas"  # one-device mesh
    return eng


def _engine(model, **kw):
    return PagedServingEngine(model, device="cpu",
                              **dict(GEOM, kv_dtype="int8", **kw))


def _assert_pools_agree(tstate, jstate, bs):
    """As the module docstring says; rows of block 0 are skipped."""
    for key in ("k", "v"):
        q = tstate[key].numpy()[:, bs:].astype(np.int64)
        q_ref = np.array(jstate[key])[:, bs:].astype(np.int64)
        s = tstate[key + "s"].numpy()[:, bs:]
        s_ref = np.array(jstate[key + "s"])[:, bs:]
        np.testing.assert_allclose(s, s_ref, rtol=1e-5, atol=0)
        same = (s == s_ref)[..., None] & np.ones(q.shape, bool)
        np.testing.assert_array_equal(q[same], q_ref[same])
        assert np.abs(q - q_ref).max() <= 1
        deq = q * s[..., None].astype(np.float64)
        deq_ref = q_ref * s_ref[..., None].astype(np.float64)
        assert (np.abs(deq - deq_ref)
                <= s_ref[..., None] * (1 + 1e-5) + 1e-5).all()


def test_engine_prefill_pools_and_decode_match_reference(jax_model, model,
                                                        jax_engine):
    teng = _engine(model)
    state = teng.init_state()
    assert state["k"].dtype == torch.int8
    assert state["ks"].shape == state["k"].shape[:-1]
    assert state["ks"].dtype == torch.float32
    rng = np.random.RandomState(1)
    long_prompt = rng.randint(0, 32, size=21).tolist()  # two chunks
    short_prompt = rng.randint(0, 32, size=11).tolist()
    tables = {0: [3, 1, 4], 1: [2, 5]}
    jstate = jax_engine.init_state()
    for rows in (
        [{"tokens": long_prompt[:16], "p0": 0, "table": tables[0]},
         {"tokens": short_prompt, "p0": 0, "table": tables[1]}],
        [{"tokens": long_prompt[16:], "p0": 16, "table": tables[0]}],
    ):
        jstate, jlogits = jax_engine.prefill_chunks(jax_model.params, jstate,
                                                    rows)
        tlogits = teng.prefill_chunks(state, rows)
        np.testing.assert_allclose(tlogits.numpy()[:len(rows)],
                                   np.array(jlogits)[:len(rows)], rtol=0,
                                   atol=1e-4)
    _assert_pools_agree(state, jstate, GEOM["block_size"])
    table_arr = np.zeros((2, teng.blocks_per_seq), np.int32)
    table_arr[0, :3] = tables[0]
    table_arr[1, :2] = tables[1]
    tokens = np.array([7, 3], np.int32)
    lengths = np.array([len(long_prompt), len(short_prompt)], np.int32)
    active = np.array([True, True])
    for _ in range(3):
        # the tick from the reference's own state, loaded into the port
        loaded = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
        jstate, jlogits = jax_engine.decode_step_paged(
            jax_model.params, jstate, tokens, table_arr, lengths, active)
        tlogits = teng.decode_step_paged(loaded, tokens, table_arr, lengths,
                                         active)
        np.testing.assert_allclose(tlogits.numpy(), np.array(jlogits),
                                   rtol=0, atol=1e-4)
        tokens = np.argmax(np.array(jlogits), axis=-1).astype(np.int32)
        lengths = lengths + 1


def test_block_bytes_and_budget_match_reference(jax_model, model, jax_engine):
    jfp = JaxPaged(jax_model, **GEOM)
    for teng, jeng in ((_engine(model), jax_engine),
                       (PagedServingEngine(model, device="cpu", **GEOM), jfp)):
        assert teng.kv_block_bytes() == jeng.kv_block_bytes()
        for budget in (0, 1, 64 * jfp.kv_block_bytes(), 10 ** 9 + 7):
            assert teng.blocks_at_budget(budget) == jeng.blocks_at_budget(
                budget)
    fp32 = PagedServingEngine(model, device="cpu", **GEOM)
    budget = 64 * fp32.kv_block_bytes()
    ratio = _engine(model).blocks_at_budget(budget) / fp32.blocks_at_budget(
        budget)
    assert ratio >= 2.0  # 2.67 at head_dim 8


def _reference_logits(jax_engine, params, prompt):
    """The reference int8 engine's logits after ``prompt``, from a fresh
    state (for the margin of a divergence)."""
    state = jax_engine.init_state()
    n_blocks = jax_engine.max_seq_blocks(len(prompt))
    table = list(range(1, n_blocks + 1))
    cap = GEOM["prefill_chunk"]
    logits = None
    for p0 in range(0, len(prompt), cap):
        rows = [{"tokens": prompt[p0:p0 + cap], "p0": p0, "table": table}]
        state, logits = jax_engine.prefill_chunks(params, state, rows)
    return np.array(logits)[0]


def test_scheduler_tokens_match_reference(jax_model, model, jax_engine):
    """Greedy tokens through the int8 pool, prefix hits and chunked
    prefill included, against the reference int8 engine: each token is
    the argmax of the reference's logits after the prompt and the
    port's tokens so far, prefilled into a fresh state.  (The
    reference's own scheduler is no oracle here: on this jaxlib its
    paged engine changes its tokens once it has served other requests,
    ``test_serving_paged.py::test_paged_scheduler_interleaved_matches_
    serial``.)"""
    rng = np.random.RandomState(4)
    system = rng.randint(0, 32, size=16).tolist()
    prompts = {
        "a": (system + [5, 9, 1], 8),
        "b": (rng.randint(0, 32, size=30).tolist(), 6),
        "c": (system + [2, 2], 7),
        "d": (rng.randint(0, 32, size=5).tolist(), 9),
    }
    tsched = ContinuousBatchingScheduler(_engine(model))
    for rid, (p, n) in prompts.items():
        tsched.submit(Request(id=rid, prompt=list(p), max_new_tokens=n))
    tsched.run()
    assert tsched.stats["prefix_hits"] >= 1
    for rid, (prompt, n) in prompts.items():
        got = tsched.finished[rid]
        assert len(got) == n
        for i, tok in enumerate(got):
            lg = _reference_logits(jax_engine, jax_model.params,
                                   list(prompt) + got[:i])
            if tok != int(np.argmax(lg)):
                top2 = np.sort(lg)[-2:]
                assert top2[1] - top2[0] < TIE_MARGIN, (rid, i, top2)
                break


def test_prefix_reuse_and_chunking_do_not_change_tokens(model):
    """Quantization is per row and once, on write: a prefix hit reads
    the same bytes, and chunk boundaries cannot move the numerics."""
    rng = np.random.RandomState(5)
    system = rng.randint(0, 32, size=16).tolist()
    reqs = [("a", system + [1, 2, 3], 6), ("b", system + [4], 5),
            ("c", system + [7, 7, 7, 7], 4)]
    eng = _engine(model)

    def serve(reuse):
        sched = ContinuousBatchingScheduler(eng)
        if not reuse:
            sched.prefix = _NoPrefix()
        for rid, p, n in reqs:
            sched.submit(Request(id=rid, prompt=list(p), max_new_tokens=n))
            sched.step()  # space the arrivals so that reuse engages
        return sched.run(), sched.stats["prefix_hits"]

    with_reuse, hits = serve(True)
    assert hits >= 1
    without, no_hits = serve(False)
    assert no_hits == 0 and without == with_reuse
    prompt = rng.randint(0, 32, size=37).tolist()
    whole = _engine(model, prefill_chunk=None)
    assert whole.greedy(prompt, 10) == _engine(model).greedy(prompt, 10)


class _NoPrefix:
    """A prefix cache that never matches and never stores."""

    def match(self, prompt):
        return [], 0

    def insert(self, prompt, blocks):
        return 0

    def evict_unused(self):
        return 0

    def __len__(self):
        return 0


def test_bf16_compute_dtype_serves_from_the_int8_pool():
    m = TransformerLM(dict(ARCH, compute_dtype="bfloat16"), seed=2,
                      device="cpu")
    eng = PagedServingEngine(m, device="cpu", kv_dtype="int8", **GEOM)
    state = eng.init_state()
    assert state["k"].dtype == torch.int8
    assert eng.kv_block_bytes() == 2 * 2 * 8 * 4 * (8 + 4)
    out = eng.greedy([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2], 6)
    assert len(out) == 6 and all(0 <= t < ARCH["vocab_size"] for t in out)


def test_int8_greedy_stays_close_to_fp32(model):
    """int8 KV is lossy: the reference's bounded-drift contract, most
    greedy tokens agree with the fp32 pool's."""
    fp32 = PagedServingEngine(model, device="cpu", **GEOM)
    i8 = _engine(model)
    rng = np.random.RandomState(6)
    agree = total = 0
    for n in (5, 19, 33):
        prompt = rng.randint(0, 32, size=n).tolist()
        a, b = fp32.greedy(prompt, 8), i8.greedy(prompt, 8)
        agree += sum(x == y for x, y in zip(a, b))
        total += 8
    assert agree / total >= 0.8


def test_kv_dtype_validation(model):
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedServingEngine(model, device="cpu", kv_dtype="fp8", **GEOM)

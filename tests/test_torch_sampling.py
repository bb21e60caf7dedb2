"""The port's sampled requests against the JAX reference, on the CPU.

Torch cannot reproduce ``jax.random``, so the port draws its own Gumbel
noise (``sampling.gumbel_noise`` from ``request_seed``).  Parity is held
by injection: the reference's draw is ``jax.random.categorical(key,
x)``, which is ``argmax(x + jax.random.gumbel(key, x.shape))``; handed
that same noise, the port's pick must equal the reference's
``Sampler.sample`` / ``pick_batch`` token for token (exact: both divide
the masked fp32 logits by ``max(T, 1e-6)`` as IEEE divisions and add
the same fp32 noise).  Then the port's own draw: reproducible per
(seed, id, token index), independent of batching and interleaving, and
every sampled token inside its row's top-k.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models.transformer import TransformerLM as JaxLM
from theanompi_tpu.runtime.mesh import make_mesh
from theanompi_tpu.serving.sampling import Sampler as JaxSampler
from theanompi_tpu.serving.sampling import request_key
from theanompi_tpu_torch.convert import params_from_jax
from theanompi_tpu_torch.models.transformer import TransformerLM
from theanompi_tpu_torch.serving import (
    ContinuousBatchingScheduler,
    PagedServingEngine,
    Request,
    Sampler,
    ServingEngine,
)
from theanompi_tpu_torch.serving import sampling as SM

V = 37
TEMPS = [0.0, 0.5, 1.0, 2.0]
TOP_KS = [0, 1, 5, V]
ARCH = dict(seq_len=64, vocab_size=32, d_model=32, n_heads=4, n_layers=2)
JAX_CFG = dict(ARCH, batch_size=2, n_synth_train=2, n_synth_val=1,
               comm_probe=False, print_freq=10_000)
GEOM = dict(n_slots=2, max_len=64, buckets=(8, 16, 64), block_size=8,
            prefill_chunk=16)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Leave the CPU to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _logits(seed, n=6):
    rng = np.random.RandomState(seed)
    lg = (rng.randn(n, V) * 3).astype(np.float32)
    lg[1, [4, 9, 20]] = lg[1].max() + 1.0  # an exact three-way tie
    return lg


def _ref_noise(seed, rid, index):
    return np.array(jax.random.gumbel(request_key(seed, rid, index), (V,)))


@pytest.mark.parametrize("top_k", TOP_KS)
@pytest.mark.parametrize("temperature", TEMPS)
def test_pick_with_injected_noise_equals_reference(temperature, top_k):
    lg = _logits(int(temperature * 10) + top_k)
    n = lg.shape[0]
    draws = [(7, f"r{i}", 3 * i) for i in range(n)]
    noise = np.stack([_ref_noise(*d) for d in draws])
    jsampler = JaxSampler()
    want_single = [jsampler.sample(jnp.asarray(lg[i]),
                                   request_key(*draws[i]), temperature,
                                   top_k) for i in range(n)]
    keys = np.stack([np.asarray(request_key(*d)) for d in draws])
    want_batch = jsampler.pick_batch(lg, keys, [temperature] * n,
                                     [top_k] * n).tolist()
    assert want_batch == want_single
    sampler = Sampler()
    got = sampler.pick_batch(torch.from_numpy(lg), torch.from_numpy(noise),
                             [temperature] * n, [top_k] * n)
    assert got.tolist() == want_batch
    for i in range(n):
        assert sampler.sample(torch.from_numpy(lg[i]),
                              torch.from_numpy(noise[i]), temperature,
                              top_k) == want_single[i]


def test_mixed_rows_equal_reference_pick_batch():
    """One batch of rows with every (T, top_k) of the grid: each row
    uses only its own noise, temperature and top-k."""
    grid = [(t, k) for t in TEMPS for k in TOP_KS]
    rng = np.random.RandomState(3)
    lg = (rng.randn(len(grid), V) * 2).astype(np.float32)
    draws = [(None if i % 3 == 0 else i, f"id{i}", i)
             for i in range(len(grid))]
    keys = np.stack([np.asarray(request_key(*d)) for d in draws])
    temps = [t for t, _ in grid]
    ks = [k for _, k in grid]
    want = JaxSampler().pick_batch(lg, keys, temps, ks)
    noise = np.stack([_ref_noise(*d) for d in draws])
    got = Sampler().pick_batch(torch.from_numpy(lg), torch.from_numpy(noise),
                               temps, ks)
    np.testing.assert_array_equal(got, want)


def test_request_seed_is_stable_and_unseeded_uses_crc32_of_the_id():
    w = SM.request_seed(5, "a", 3)
    assert 0 <= w < 2 ** 32 and w == SM.request_seed(5, "a", 3)
    assert SM.request_seed(5, "b", 3) == w  # a seeded stream ignores the id
    assert len({SM.request_seed(5, "a", i) for i in range(64)}) == 64
    assert len({SM.request_seed(s, "a", 0) for s in range(64)}) == 64
    assert SM.request_seed(None, "req-7", 2) == SM.request_seed(
        zlib.crc32(b"req-7"), "other", 2)
    assert SM.request_seed(-1, "a", 0) != SM.request_seed(1, "a", 0)
    assert SM.request_seed(2 ** 40 + 5, "a", 0) != SM.request_seed(5, "a", 0)


def test_gumbel_noise_is_finite_and_gumbel_distributed():
    g32 = SM.gumbel_noise(np.arange(64), 4096)
    assert g32.dtype == torch.float32 and g32.shape == (64, 4096)
    g = g32.double()
    assert torch.isfinite(g).all()
    # Gumbel(0, 1): mean = Euler–Mascheroni 0.5772, variance π²/6
    assert abs(float(g.mean()) - 0.5772) < 0.01
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03
    np.testing.assert_array_equal(SM.gumbel_noise([9, 3], 50)[1].numpy(),
                                  SM.gumbel_noise([3], 50)[0].numpy())


# ---------------------------------------------------------------------------
# the scheduler
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


SAMPLED = {
    "s1": dict(prompt=[3, 1, 4, 1, 5, 9, 2, 6], n=9, temperature=0.8,
               top_k=5, seed=11),
    "s2": dict(prompt=list(range(20)), n=7, temperature=1.5, top_k=0,
               seed=None),
    "g": dict(prompt=[7, 7, 2, 9, 4], n=6, temperature=0.0, top_k=0,
              seed=None),
    "s3": dict(prompt=[30, 1, 30, 2, 30, 3, 30, 4, 30, 5, 30], n=8,
               temperature=0.5, top_k=1, seed=3),
}


def _requests(make, ids, **over):
    out = []
    for rid in ids:
        r = dict(SAMPLED[rid], **over)
        out.append(make(id=rid, prompt=list(r["prompt"]),
                        max_new_tokens=r["n"], temperature=r["temperature"],
                        top_k=r["top_k"], seed=r["seed"]))
    return out


def _serve(sched, reqs):
    for r in reqs:
        sched.submit(r)
    return sched.run()


def _reference_margin(lg, key, temperature, top_k):
    """Top-2 margin of what the reference's pick is decided on."""
    if temperature == 0:
        top2 = np.sort(lg)[-2:]
        return float(top2[1] - top2[0])
    lg = lg.astype(np.float32)
    kth = np.sort(lg)[::-1][min(max(top_k, 1), lg.size) - 1]
    masked = np.where((top_k > 0) & (lg < kth), np.float32(-1e30), lg)
    scores = masked / np.float32(max(temperature, 1e-6)) + np.array(
        jax.random.gumbel(key, lg.shape))
    top2 = np.sort(scores)[-2:]
    return float(top2[1] - top2[0])


def test_scheduler_with_reference_noise_equals_reference_picks(
        jax_model, model, monkeypatch):
    """The paged scheduler's requests, sampled with the reference's own
    noise, against the reference's picks: each token is the reference
    ``Sampler.sample`` with the request's key on the reference's
    full-recompute logits after the prompt and the port's tokens so
    far.  A difference would pass only where the reference's decision
    margin is below 1e-4 (the frameworks' logits differ by ~1e-6).
    (The reference's paged scheduler is no oracle: on this jaxlib it
    changes its tokens once its engine has served other requests.)"""
    draws = []  # word w > 0 names draws[w - 1]; 0 marks a greedy row

    def word(seed, rid, index):
        draws.append((seed, rid, index))
        return len(draws)

    def noise(words, vocab, device=None):
        return torch.from_numpy(np.stack([
            np.array(jax.random.gumbel(request_key(*draws[w - 1]), (vocab,)))
            if w else np.zeros(vocab, np.float32) for w in words]))

    monkeypatch.setattr(
        "theanompi_tpu_torch.serving.scheduler.request_seed", word)
    monkeypatch.setattr(
        "theanompi_tpu_torch.serving.scheduler.gumbel_noise", noise)
    ids = sorted(SAMPLED)
    got = _serve(ContinuousBatchingScheduler(
        PagedServingEngine(model, device="cpu", **GEOM)),
        _requests(Request, ids))
    assert draws  # the sampled rows drew the injected noise
    fwd = jax.jit(lambda x: jax_model.net.apply(
        jax_model.params, jax_model.net_state, x)[0])
    jsampler = JaxSampler()
    for rid in ids:
        r = SAMPLED[rid]
        toks = list(r["prompt"])
        for i, tok in enumerate(got[rid]):
            x = np.zeros((1, ARCH["seq_len"]), np.int32)
            x[0, :len(toks)] = toks
            lg = np.array(fwd(jnp.asarray(x)))[0, len(toks) - 1]
            key = request_key(r["seed"], rid, i)
            want = jsampler.sample(jnp.asarray(lg), key, r["temperature"],
                                   r["top_k"])
            if tok != want:
                margin = _reference_margin(lg, key, r["temperature"],
                                           r["top_k"])
                assert margin < 1e-4, (rid, i, margin)
                break
            toks.append(tok)


def _within_top_k(model, req):
    """Every sampled token is among its row's top_k logits (no-cache
    full-recompute forward)."""
    toks = list(req.prompt)
    with torch.no_grad():
        for t in req.output:
            lg = model(torch.tensor([toks]))[0, -1]
            if req.top_k:
                assert lg[t] >= torch.topk(lg, req.top_k).values[-1]
            toks.append(t)


@pytest.mark.parametrize("engine", ["paged", "paged_int8", "contiguous"])
def test_sampled_streams_are_reproducible_and_interleaving_free(model,
                                                               engine):
    def make_engine(n_slots):
        if engine == "contiguous":
            return ServingEngine(model, n_slots=n_slots, max_len=64,
                                 buckets=(8, 16, 64), device="cpu")
        kv = "int8" if engine == "paged_int8" else "fp32"
        return PagedServingEngine(model, device="cpu", kv_dtype=kv,
                                  **dict(GEOM, n_slots=n_slots))

    ids = sorted(SAMPLED)
    together = _serve(ContinuousBatchingScheduler(make_engine(3)),
                      _requests(Request, ids))
    for rid in ids:
        alone = _serve(ContinuousBatchingScheduler(make_engine(1)),
                       _requests(Request, [rid]))
        assert alone[rid] == together[rid], rid
    again = _serve(ContinuousBatchingScheduler(make_engine(2)),
                   _requests(Request, ids[::-1]))
    assert again == together
    # another seed draws another stream; an unseeded request's stream
    # is its id's
    other = _serve(ContinuousBatchingScheduler(make_engine(2)),
                   _requests(Request, ["s1"], seed=12))
    assert other["s1"] != together["s1"]
    if engine != "paged_int8":
        for r in _requests(Request, ids):
            r.output = together[r.id]
            _within_top_k(model, r)
    # greedy rows ride along unchanged
    greedy = make_engine(1).greedy(SAMPLED["g"]["prompt"], SAMPLED["g"]["n"])
    assert together["g"] == greedy


def test_token_index0_continues_a_stream(model):
    """A request that replays its first k tokens as prompt, with
    ``token_index0 = k``, draws what the original stream drew next."""
    eng = PagedServingEngine(model, device="cpu", **GEOM)
    r = SAMPLED["s1"]
    full = _serve(ContinuousBatchingScheduler(eng),
                  _requests(Request, ["s1"]))["s1"]
    k = 4
    resumed = Request(id="s1", prompt=r["prompt"] + full[:k],
                      max_new_tokens=r["n"] - k, temperature=r["temperature"],
                      top_k=r["top_k"], seed=r["seed"], token_index0=k)
    got = _serve(ContinuousBatchingScheduler(eng), [resumed])["s1"]
    assert got == full[k:]


def test_request_validation():
    with pytest.raises(ValueError, match="temperature"):
        Request(id="x", prompt=[1], temperature=-0.1)
    with pytest.raises(ValueError, match="top_k"):
        Request(id="x", prompt=[1], temperature=1.0, top_k=-1)
    r = Request(id="x", prompt=[1], temperature=0.7, top_k=3, seed=4)
    assert (r.top_k, r.seed, r.token_index0) == (3, 4, 0)

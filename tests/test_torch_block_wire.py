"""The block-quantized gradient wire of the port at a world of 2 against
the reference's two-device mesh, on the CPU.

One two-rank gloo job (separate processes, ``runtime.dist`` over
``env://``, the plain quantizers) runs every multi-rank case and saves
what it saw; the reference runs the same inputs on
``make_mesh(devices=jax.devices()[:2])``.

- ``reduce_grads`` for each block strategy, per tensor and bucketed, on
  fixed per-rank gradients (three tensors of 9000, 300 and 5000
  elements: some ride the fp32 fallback per tensor, the bucket
  quantizes).  The SR strategies take seed words drawn from the
  reference's own keys (``fold_in(rng, u)``, ``fold_in(·, 0)``,
  ``split``, ``jax.random.bits``).
- ``_leg1_pack`` at the fallback threshold, ``reduce_with_residual``
  and ``local_roundtrip``, and error feedback's recovery of floored
  gradients, per tensor and bucketed.
- One TransformerLM BSP step (small width, ``pallas_int8``) against the
  reference's step, and ``BSP().init(devices=2, ...)`` training the LM
  with its default ``int8_sr``.

Tolerances, and why:

- ``int8``, ``pallas_int8``, ``pallas_int8_sr``, ``fp16s``,
  ``pallas_fp16s``: the port computes every product and quotient once,
  correctly rounded; the reference's jitted program on XLA:CPU contracts
  the shard sum ``Σ q·s`` into fused multiply-adds and rewrites the
  division by the constant 127 as a multiplication by ``fp32(1/127)``
  (its Pallas kernels under interpret mode do the latter too).  Sums
  and scales then differ by an ulp in some rows (here: one tensor's
  ``int8`` mean in 5.6 % of its elements, ``fp16s`` in 4.8 %), and
  rarely a rounding of the next leg flips by one quantum.  So: at least
  99 % of the elements within 1e-6 relative, and every element within
  two quanta — 2·max|g|/127 for int8 (the reference's own wire bound in
  ``test_int8_reduce_matches_true_mean``), 2·max|g|·2⁻¹¹ for fp16s (fp16
  keeps 11 bits of the block value scaled to 256).
- ``int8_sr``: the reference draws ``jax.random.uniform``, the port the
  counter hash; both are held to the true mean within 2·max|g|/127.
- Error feedback: the reference's bound, the floored component's sum
  over 60 steps within 1.1 quanta of 60·1e-4, and exactly 0 without
  error feedback.
- The LM step: every updated parameter and velocity within the
  learning rate times two int8 quanta of the largest gradient of either
  rank (the ranks' fp32 gradients already differ from the reference's
  by summation order, so scales and roundings move in more rows than
  above); loss atol 1e-5 (fp32, summation order).
- Every rank returns bitwise the same reduced values and parameters.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from theanompi_tpu.models.transformer import TransformerLM as JaxLM
from theanompi_tpu.parallel.exchanger import BSP_Exchanger as JaxExchanger
from theanompi_tpu.runtime.mesh import DATA_AXIS, make_mesh, shard_batch
from theanompi_tpu_torch.convert import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_STRATEGIES = ("int8", "pallas_int8", "int8_sr", "pallas_int8_sr",
                    "fp16s", "pallas_fp16s")
SIZES = {"a": 9000, "b": 300, "c": 5000}
BUCKET = 4 << 20
K_EF = 60
LM_CFG = dict(batch_size=2, seq_len=32, vocab_size=32, d_model=32,
              n_heads=4, n_layers=2, n_synth_train=8, n_synth_val=1,
              print_freq=10_000, weight_decay=0.0, comm_probe=False, seed=3,
              attn_impl="flash")

RANK_MAIN = r"""
import hashlib, os, sys
import numpy as np, torch
torch.set_num_threads(1)
from theanompi_tpu_torch import BSP
from theanompi_tpu_torch.parallel import quantize as Q
from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
from theanompi_tpu_torch.models.transformer import TransformerLM
from theanompi_tpu_torch.runtime.dist import init_process_group
inp, out = sys.argv[1], sys.argv[2]
blob = torch.load(inp)
world = init_process_group("cpu")
rank = world.rank
assert (world.size, world.backend) == (2, "gloo")
res = {"rank": rank}
names = list(blob["sizes"])
grads = [blob["grads"][k][rank] for k in names]
for strategy in blob["strategies"]:
    for mode, bb in (("leaf", None), ("bucket", blob["bucket"])):
        ex = BSP_Exchanger(strategy, bucket_bytes=bb)
        seeds = blob["seeds"].get((strategy, mode))
        res[(strategy, mode)] = ex.reduce_grads(grads, names, seeds)
# _leg1_pack at the threshold, int8 (chunk = 2 * 256)
ex = BSP_Exchanger("int8")
for n in blob["edge_sizes"]:
    g = blob["edge"][n]
    packed = ex._leg1_pack(g)
    res[("edge", n)] = (None if packed is None else
                        (packed["n"], Q.dequantize(packed["q"], packed["s"])))
    res[("edge_rt", n)] = ex.local_roundtrip([g], ["g"])[0]
# reduce_with_residual and local_roundtrip, per tensor and bucketed
for strategy in ("ar", "int8", "pallas_int8"):
    for mode, bb in (("leaf", None), ("bucket", blob["bucket"])):
        ex = BSP_Exchanger(strategy, bucket_bytes=bb)
        red, rt = ex.reduce_with_residual(grads, names)
        res[("rwr", strategy, mode)] = (red, rt,
                                        ex.local_roundtrip(grads, names))
# error feedback recovers floored gradients (every rank sends the same g)
g = blob["ef_g"]
split = blob["ef_split"]
for mode, bb in (("leaf", None), ("bucket", blob["bucket"])):
    ex = BSP_Exchanger("int8", bucket_bytes=bb)
    parts = [g] if bb is None else [g[:split], g[split:]]
    pn = [str(i) for i in range(len(parts))]
    e = [torch.zeros_like(p) for p in parts]
    total = torch.zeros(g.numel(), dtype=torch.float64)
    for _ in range(blob["k_ef"]):
        send = [p + r for p, r in zip(parts, e)]
        if bb is None:
            rt = ex.local_roundtrip(send, pn)
            red = ex.reduce_grads(send, pn)
        else:
            red, rt = ex.reduce_with_residual(send, pn)
        e = [s - r for s, r in zip(send, rt)]
        total += torch.cat([r.reshape(-1) for r in red]).double()
    control = torch.cat([r.reshape(-1) for r in ex.reduce_grads(parts, pn)])
    res[("ef", mode)] = (total, control)
# one LM step on the pallas_int8 wire
cfg = blob["lm_cfg"]
m = TransformerLM(config=dict(cfg, exch_strategy="pallas_int8"), device="cpu")
assert (m.rank, m.n_workers) == (rank, 2)
m.load_state_dict(blob["lm_state"])
b = cfg["batch_size"]
x, y = (a[rank * b:(rank + 1) * b] for a in blob["lm_batch"])
g = torch.autograd.grad(m.loss_and_metrics(x, y, True)[0], m.params)
gmax = torch.stack([t.abs().max() for t in g]).max().reshape(1)
torch.distributed.all_reduce(gmax, op=torch.distributed.ReduceOp.MAX)
loss, err = m.compile_train()(x, y)
res["lm"] = dict(loss=float(loss), gmax=float(gmax[0]), state=m.state_dict(),
                 velocity={"net." + n: v for n, v in zip(
                     m.param_names, m.opt_state["velocity"])})
# BSP trains the LM with its default wire, int8_sr
rule = BSP()
rule.init(devices=2, modelfile="theanompi_tpu_torch.models.transformer",
          modelclass="TransformerLM", device="cpu",
          model_config=dict(cfg, n_epochs=2, print_freq=2, seed=5))
model = rule.wait()
res["bsp"] = dict(
    strategy=model.config.exch_strategy, backend=model.world.backend,
    costs=[r["cost"] for r in rule.worker.recorder.history],
    launches=Q.launches(),
    digest=hashlib.sha1(b"".join(p.detach().numpy().tobytes()
                                 for p in model.params)).hexdigest())
torch.save(res, out + f".{rank}")
"""


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Leave the CPU to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _grads():
    """Per-rank gradients: name → (2, n) fp32, the ranks' rows."""
    rng = np.random.RandomState(0)
    return {k: (rng.randn(2, n) * rng.uniform(0.1, 3.0, (2, 1)))
            .astype(np.float32) for k, n in SIZES.items()}


def _seed_words(rng, n_units):
    """The reference's key order for unit u on its one exchange axis:
    fold_in(rng, u) → fold_in(·, 0) → split into the two legs' keys,
    each drawn as jax.random.bits(key, (1, 1), uint32)."""
    words = []
    for u in range(n_units):
        k1, k2 = jax.random.split(
            jax.random.fold_in(jax.random.fold_in(rng, u), 0))
        words.append(tuple(
            int(np.asarray(jax.random.bits(k, (1, 1), jnp.uint32))[0, 0])
            for k in (k1, k2)))
    return words


def _lm_batch():
    rng = np.random.RandomState(4)
    b = 2 * LM_CFG["batch_size"]
    return (rng.randint(0, 32, (b, 32)).astype(np.int32),
            rng.randint(0, 32, (b, 32)).astype(np.int32))


def _lm_batch_tensors():
    return tuple(torch.from_numpy(a) for a in _lm_batch())


def _ef_input():
    n = 2 * 256  # world · BLOCK: one block per rank shard
    g = np.full(n, 1e-4, np.float32)
    g[::256] = 1.0  # pins every block's int8 scale at ~1/127
    return g, 3 * 256 + 17  # bucketed: a seam inside a block


def _reference_wires(mesh, grads):
    """Every reduction of the file on the mesh, in one program:
    ``reduce_grads`` per (strategy, mode), and ``reduce_with_residual``
    with ``local_roundtrip`` per int8 strategy and mode."""
    rng = jax.random.PRNGKey(11)
    modes = (("leaf", None), ("bucket", BUCKET))
    red_ex = {f"{s}/{m}": JaxExchanger(s, axis=DATA_AXIS, mesh=mesh,
                                       bucket_bytes=bb)
              for s in BLOCK_STRATEGIES for m, bb in modes}
    rwr_ex = {f"{s}/{m}": JaxExchanger(s, axis=DATA_AXIS, mesh=mesh,
                                       bucket_bytes=bb)
              for s in ("ar", "int8", "pallas_int8") for m, bb in modes}

    def step(tree):
        tree = {k: v[0] for k, v in tree.items()}
        red = {key: ex.reduce_grads(tree, rng=rng)
               for key, ex in red_ex.items()}
        rwr = {}
        for key, ex in rwr_ex.items():
            r, rt = ex.reduce_with_residual(tree)
            lrt = ex.local_roundtrip(tree)
            rwr[key] = (r, {k: v[None] for k, v in rt.items()},
                        {k: v[None] for k, v in lrt.items()})
        return red, rwr

    out_specs = (P(), {key: (P(), P(DATA_AXIS), P(DATA_AXIS))
                       for key in rwr_ex})
    fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P(DATA_AXIS),),
                               out_specs=out_specs, check_vma=False))
    red, rwr = fn({k: jnp.asarray(v) for k, v in grads.items()})
    out = {}
    for key, tree in red.items():
        strategy, mode = key.split("/")
        out[(strategy, mode)] = {k: np.asarray(v) for k, v in tree.items()}
    for key, trees in rwr.items():
        strategy, mode = key.split("/")
        out[("rwr", strategy, mode)] = tuple(
            {k: np.asarray(v) for k, v in t.items()} for t in trees)
    return out


@pytest.fixture(scope="module")
def reference():
    mesh = make_mesh(devices=jax.devices()[:2])
    out = _reference_wires(mesh, _grads())
    ex = JaxExchanger("int8", axis=DATA_AXIS, mesh=mesh)
    for n in (127, 128, 129):
        g = np.random.RandomState(n).randn(n).astype(np.float32)
        packed = ex._leg1_pack(jnp.asarray(g), DATA_AXIS)
        out[("edge_in", n)] = g
        out[("edge", n)] = (None if packed is None else (
            packed["n"], np.asarray(packed["dequant"](packed["q"],
                                                      packed["s"]))))
    # one LM step, pallas_int8, on the two-device mesh
    jm = JaxLM(config=dict(LM_CFG, exch_strategy="pallas_int8"), mesh=mesh)
    before = jax.tree.map(np.array, jm.params)
    xs, ys = shard_batch(mesh, _lm_batch())
    r = jm.compile_train()(jm.params, jm.net_state, jm.opt_state, xs, ys,
                           jax.random.PRNGKey(1))
    out["lm"] = dict(
        before=before, loss=float(r[3]),
        after=params_from_jax(jax.tree.map(np.array, r[0])),
        velocity=params_from_jax(jax.tree.map(np.array, r[2]["velocity"])))
    return out


@pytest.fixture(scope="module")
def two_ranks(reference, tmp_path_factory):
    d = tmp_path_factory.mktemp("block_wire")
    inp, out = d / "in.pt", d / "out.pt"
    grads = _grads()
    rng = jax.random.PRNGKey(11)
    n_bucket = 1  # every tensor fits one 4 MB bucket
    seeds = {}
    for strategy in ("int8_sr", "pallas_int8_sr"):
        seeds[(strategy, "leaf")] = _seed_words(rng, len(SIZES))
        seeds[(strategy, "bucket")] = _seed_words(rng, n_bucket)
    ef_g, ef_split = _ef_input()
    torch.save(dict(
        sizes=SIZES, strategies=BLOCK_STRATEGIES, bucket=BUCKET,
        grads={k: torch.from_numpy(v) for k, v in grads.items()},
        seeds=seeds, edge_sizes=(127, 128, 129),
        edge={n: torch.from_numpy(reference[("edge_in", n)])
              for n in (127, 128, 129)},
        ef_g=torch.from_numpy(ef_g), ef_split=ef_split, k_ef=K_EF,
        lm_cfg=LM_CFG, lm_state=params_from_jax(reference["lm"]["before"]),
        lm_batch=_lm_batch_tensors()), inp)
    env = dict(os.environ, PYTHONPATH=ROOT, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, str(inp), str(out)],
            cwd=ROOT, env=dict(env, RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [torch.load(f"{out}.{r}") for r in range(2)]


def _same_on_both_ranks(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        for k in a:
            _same_on_both_ranks(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        for x, y in zip(a, b, strict=True):
            _same_on_both_ranks(x, y)
    else:
        assert a == b


def _quanta(strategy, gmax):
    """Two quanta of the wire for gradients of largest magnitude gmax."""
    return 2.0 * gmax * (2.0 ** -11 if "fp16" in strategy else 1 / 127.0)


def _within_wire(got, want, atol, share=0.99):
    """All elements within ``atol`` (two quanta) and at least ``share``
    of them within 1e-6 relative."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    close = np.abs(got - want) <= 1e-6 * np.abs(want) + 1e-12
    assert close.mean() >= share, close.mean()


@pytest.mark.parametrize("mode", ["leaf", "bucket"])
@pytest.mark.parametrize("strategy", BLOCK_STRATEGIES)
def test_reduce_grads_matches_reference_two_device_mesh(strategy, mode,
                                                        reference,
                                                        two_ranks):
    got = two_ranks[0][(strategy, mode)]
    _same_on_both_ranks(got, two_ranks[1][(strategy, mode)])
    want = reference[(strategy, mode)]
    grads = _grads()
    for k, g in zip(SIZES, got):
        g = g.numpy()
        true_mean = grads[k].mean(axis=0)
        gmax = float(np.abs(np.concatenate(
            [v.reshape(-1) for v in grads.values()] if mode == "bucket"
            else [grads[k].reshape(-1)])).max())
        if strategy != "int8_sr":
            _within_wire(g, want[k], _quanta(strategy, gmax))
        else:  # int8_sr: other dither, the same bound to the true mean
            np.testing.assert_allclose(g, true_mean, rtol=0,
                                       atol=2.0 * gmax / 127.0, err_msg=k)
            np.testing.assert_allclose(want[k], true_mean, rtol=0,
                                       atol=2.0 * gmax / 127.0, err_msg=k)


def test_the_wire_quantizes_where_the_reference_does(two_ranks):
    """Not the fp32 fallback in disguise: pallas_int8's chunk is
    2·256·32, so per tensor a (9000) and c (5000) quantize (4n ≥ 16384)
    and only b (300) rides the exact all_reduce; bucketed, all do."""
    grads = _grads()
    exact = {k: grads[k].mean(axis=0) for k in SIZES}
    got = dict(zip(SIZES, two_ranks[0][("pallas_int8", "leaf")]))
    np.testing.assert_array_equal(got["b"].numpy(), exact["b"])
    for k in ("a", "c"):
        assert (got[k].numpy() != exact[k]).any(), k
    got = dict(zip(SIZES, two_ranks[0][("pallas_int8", "bucket")]))
    assert all((got[k].numpy() != exact[k]).any() for k in SIZES)


@pytest.mark.parametrize("n", [127, 128, 129])
def test_leg1_pack_threshold_and_padding_edges(n, reference, two_ranks):
    """4n < chunk (512) rides the fallback; at and above it the padded
    image round-trips to the tensor's length, equal to the reference's."""
    got, want = two_ranks[0][("edge", n)], reference[("edge", n)]
    rt = two_ranks[0][("edge_rt", n)].numpy()
    if 4 * n < 2 * 256:
        assert got is None and want is None
        np.testing.assert_array_equal(rt, reference[("edge_in", n)])
        return
    assert got[0] == want[0] == n
    img = got[1].numpy()
    assert img.size % 512 == 0
    np.testing.assert_array_equal(img.reshape(-1), want[1].reshape(-1))
    np.testing.assert_array_equal(rt, img.reshape(-1)[:n])


@pytest.mark.parametrize("mode", ["leaf", "bucket"])
@pytest.mark.parametrize("strategy", ["ar", "int8", "pallas_int8"])
def test_reduce_with_residual_matches_reference(strategy, mode, reference,
                                                two_ranks):
    """``ar``: exact (a lossless wire; the roundtrip is the input)."""
    grads = _grads()
    red_w, rt_w, lrt_w = reference[("rwr", strategy, mode)]
    for rank in (0, 1):
        red, rt, lrt = two_ranks[rank][("rwr", strategy, mode)]
        for k, a, b, c in zip(SIZES, red, rt, lrt):
            if strategy == "ar":
                np.testing.assert_array_equal(a.numpy(), red_w[k])
                for x in (b, c):
                    np.testing.assert_array_equal(x.numpy(), grads[k][rank])
                continue
            gmax = float(np.abs(grads[k]).max()) if mode == "leaf" else \
                max(float(np.abs(v).max()) for v in grads.values())
            for x, w in ((a, red_w[k]), (b, rt_w[k][rank]),
                         (c, lrt_w[k][rank])):
                _within_wire(x.numpy(), w, _quanta(strategy, gmax))


@pytest.mark.parametrize("mode", ["leaf", "bucket"])
def test_error_feedback_recovers_floored_gradients(mode, two_ranks):
    total, control = two_ranks[0][("ef", mode)]
    _same_on_both_ranks(two_ranks[0][("ef", mode)],
                        two_ranks[1][("ef", mode)])
    tiny = float(total[1])
    lsb = 1.0 / 127.0
    assert tiny > 0.0
    assert abs(tiny - K_EF * 1e-4) <= 1.1 * lsb, tiny
    assert float(control[1]) == 0.0


def test_lm_step_on_pallas_int8_matches_reference_step(reference, two_ranks):
    """gmax: the largest |gradient| of either rank before the wire; the
    first velocity is −lr · (reduced gradient), lr 0.1."""
    ref, got = reference["lm"], two_ranks[0]["lm"]
    _same_on_both_ranks(got["state"], two_ranks[1]["lm"]["state"])
    assert abs(got["loss"] - ref["loss"]) <= 1e-5
    lr, gmax = 0.1, got["gmax"]
    atol = lr * _quanta("pallas_int8", gmax)
    for k, want in ref["after"].items():
        for a, w in ((got["state"][k], want),
                     (got["velocity"][k], ref["velocity"][k])):
            np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0,
                                       atol=atol, err_msg=k)


def test_bsp_trains_the_lm_with_its_default_int8_sr_wire(two_ranks):
    a, b = two_ranks[0]["bsp"], two_ranks[1]["bsp"]
    assert a["strategy"] == "int8_sr" and a["backend"] == "gloo"
    assert a["digest"] == b["digest"] and a["costs"] == b["costs"]
    costs = a["costs"]
    assert len(costs) == 8 and all(np.isfinite(costs))  # 2 × 8 steps / 2
    assert costs[-1] < costs[0]
    assert all(v == 0 for v in a["launches"].values())  # plain versions


def test_sr_strategies_refuse_a_call_without_seed_words():
    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger

    ex = BSP_Exchanger("pallas_int8_sr")
    with pytest.raises(ValueError, match="seed words"):
        ex._leg1_pack(torch.ones(1 << 16))


def test_error_feedback_scoping_follows_reference():
    from theanompi_tpu_torch.models.transformer import TransformerLM
    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger

    for over, match in ((dict(exch_strategy="ar"), "lossless"),
                        (dict(exch_strategy="bf16"), "cast"),
                        (dict(exch_strategy="int8", sync_mode="avg"), "cdd")):
        m = TransformerLM(config=dict(LM_CFG, error_feedback=True, **over),
                          device="cpu")
        with pytest.raises(ValueError, match=match):
            m.compile_train()
    with pytest.raises(ValueError, match="block"):
        BSP_Exchanger("fp16").local_roundtrip([torch.ones(8)])

"""The port's checkpoints against the reference's, file for file.

- Trees: a file written by ``theanompi_tpu.utils.checkpoint.save``
  restores in the port to an equal tree (same containers, Python kinds,
  dtypes and bits; tolerance 0), and a file written by the port's
  ``save`` restores in the reference the same way.
- ``AsyncCheckpointer``, ``latest``, ``prune`` and ``host_snapshot``;
  the refusal of v1 files (the port never unpickles).
- Models: the reference's AlexNet (64 px, batch 2, 10 classes, fp32,
  dropout 0, ``lrn_impl``/``pool_grad`` 'pallas', a one-device mesh)
  takes a step on the CPU and saves; the port loads the file, and the
  next step's loss and updated parameters and velocities equal the
  reference's next step to atol 1e-6 (fp32; the same bound as
  ``tests/test_torch_alexnet.py``).  The reverse direction (the port
  steps and saves, the reference loads) is held the same way.  The
  error-feedback residuals keep the reference's layout (the params
  tree, each leaf with a leading world axis), and the reference's
  refusals hold with its messages.
"""

import collections
import os

import jax
import numpy as np
import pytest
import torch

import theanompi_tpu.utils.checkpoint as ref_ckpt
import theanompi_tpu_torch.utils.checkpoint as ckpt
from theanompi_tpu.models.alex_net import AlexNet as JaxAlexNet
from theanompi_tpu.models.transformer import TransformerLM as JaxLM
from theanompi_tpu.runtime.mesh import make_mesh, shard_batch
from theanompi_tpu_torch.convert import (
    alexnet_params_from_jax, alexnet_params_to_jax, params_from_jax)
from theanompi_tpu_torch.models.alex_net import AlexNet
from theanompi_tpu_torch.models.transformer import TransformerLM

CFG = dict(image_size=64, batch_size=2, n_classes=10, lrn_impl="pallas",
           pool_grad="pallas", dropout_rate=0.0, n_synth_batches=1,
           comm_probe=False, print_freq=10_000)
ATOL = 1e-6
Pair = collections.namedtuple("Pair", ["a", "b"])


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Leave the CPU to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {
        "params": [{"w": rng.randn(3, 4).astype(np.float32),
                    "b": rng.randn(4).astype(np.float32)}, {}],
        "ints": rng.randint(-5, 5, (2, 3)).astype(np.int32),
        "u8": rng.randint(0, 255, 7).astype(np.uint8),
        "f64": rng.randn(2).astype(np.float64),
        "mask": rng.rand(5) < 0.5,
        "scalars": (np.float32(1.5), np.int32(-3), 7, 2.25, True, "ok\x00"),
        "empty": np.zeros((0, 3), np.float32),
        "none": None,
        "pair": Pair(np.arange(3, dtype=np.int64), "x"),
        "epoch": 12,
        "rng": np.array([1797259609, 2579123966], np.uint32),
    }


def _assert_same(got, want):
    assert type(got) is type(want) or (
        isinstance(want, tuple) and isinstance(got, tuple)), (got, want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        if hasattr(want, "_fields"):
            assert got._fields == want._fields
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert got == want


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_files_restore_in_the_port(tmp_path, seed):
    path = ref_ckpt.save(str(tmp_path / "ref.npz"), _tree(seed))
    _assert_same(ckpt.restore(path), ref_ckpt.restore(path))


@pytest.mark.parametrize("seed", [0, 1])
def test_port_files_restore_in_the_reference(tmp_path, seed):
    path = ckpt.save(str(tmp_path / "port.npz"), _tree(seed))
    _assert_same(ref_ckpt.restore(path), ckpt.restore(path))
    _assert_same(ckpt.restore(path), ref_ckpt.restore(
        ref_ckpt.save(str(tmp_path / "ref.npz"), _tree(seed))))


def test_tensors_are_saved_as_numpy_and_bf16_is_refused(tmp_path):
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = ref_ckpt.restore(ckpt.save(str(tmp_path / "t.npz"),
                                     {"t": t, "i": torch.tensor([1, 2])}))
    np.testing.assert_array_equal(out["t"], t.numpy())
    assert out["i"].dtype == np.int64
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save(str(tmp_path / "b.npz"), {"t": t.bfloat16()})


def test_host_snapshot_copies():
    t = torch.ones(4)
    a = np.ones(3, np.float32)
    snap = ckpt.host_snapshot({"t": t, "a": [a], "n": 3})
    t.add_(1)
    a += 1
    np.testing.assert_array_equal(snap["t"], np.ones(4, np.float32))
    np.testing.assert_array_equal(snap["a"][0], np.ones(3, np.float32))
    assert snap["n"] == 3


def test_v1_files_are_refused_without_unpickling(tmp_path):
    path = str(tmp_path / "v1.npz")
    # a v1 file: leaves plus a (here opaque) pickled-treedef entry
    np.savez(path, __meta__=np.frombuffer(b"\x80\x04not unpickled", np.uint8),
             leaf_0=np.ones(2))
    with pytest.raises(ValueError, match="v1 checkpoint"):
        ckpt.restore(path)
    np.savez(str(tmp_path / "other.npz"), x=np.ones(2))
    with pytest.raises(ValueError, match="not a theanompi_tpu checkpoint"):
        ckpt.restore(str(tmp_path / "other.npz"))


def test_async_checkpointer_writes_in_order_and_surfaces_errors(tmp_path):
    t = torch.zeros(3)
    with ckpt.AsyncCheckpointer(max_pending=1) as w:
        for i in range(3):
            t.fill_(i)
            w.save(str(tmp_path / f"ckpt_{i:04d}.npz"), {"t": t, "i": i})
        w.wait()
        for i in range(3):
            out = ref_ckpt.restore(str(tmp_path / f"ckpt_{i:04d}.npz"))
            assert out["i"] == i and (out["t"] == i).all()
        w.save(str(tmp_path / "not_a_dir.npz" / "x.npz"), {"t": t})
        (tmp_path / "not_a_dir.npz").write_text("a file")
        with pytest.raises(Exception):
            w.wait()
    with pytest.raises(RuntimeError, match="closed"):
        w.save(str(tmp_path / "late.npz"), {"t": t})


def _touch(d, names):
    d.mkdir()
    for i, name in enumerate(names):
        p = d / name
        p.write_bytes(b"x")
        os.utime(p, (1000 + (i // 2), 1000 + (i // 2)))  # mtime ties


@pytest.mark.parametrize("keep", [1, 2, 5])
def test_latest_and_prune_match_the_reference(tmp_path, keep):
    names = ["ckpt_0003.npz", "ckpt_0001.npz", "ckpt_0002.npz",
             "ckpt_0004.npz", "other_0009.npz", "ckpt_0005.npz.tmp"]
    _touch(tmp_path / "a", names)
    _touch(tmp_path / "b", names)
    assert (os.path.basename(ckpt.latest(str(tmp_path / "a")))
            == os.path.basename(ref_ckpt.latest(str(tmp_path / "b"))))
    got = [os.path.basename(p) for p in ckpt.prune(str(tmp_path / "a"), keep)]
    want = [os.path.basename(p)
            for p in ref_ckpt.prune(str(tmp_path / "b"), keep)]
    assert got == want
    assert sorted(os.listdir(tmp_path / "a")) == sorted(
        os.listdir(tmp_path / "b"))
    assert ckpt.latest(str(tmp_path / "missing")) is None
    with pytest.raises(ValueError, match="keep_last must be >= 1"):
        ckpt.prune(str(tmp_path / "a"), 0)


# ---- models -------------------------------------------------------------

def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 64, 64, 3).astype(np.float32),
            rng.randint(0, 10, 2).astype(np.int32))


def _ref_model(**over):
    return JaxAlexNet(config=dict(CFG, **over),
                      mesh=make_mesh(devices=jax.devices()[:1]))


def _ref_step(jm, seed):
    xs, ys = shard_batch(jm.mesh, _batch(seed))
    out = jm.compile_train()(jm.params, jm.net_state, jm.opt_state, xs, ys,
                             jax.random.PRNGKey(1))
    jm.params, jm.net_state, jm.opt_state = out[0], out[1], out[2]
    return float(out[3])


def _port_step(m, seed):
    x, y = _batch(seed)
    loss, _ = m.compile_train()(torch.tensor(x), torch.tensor(y))
    return float(loss)


def _port_tree(m):
    named = lambda ts: {f"net.{n}": t for n, t in zip(m.param_names, ts)}
    return (alexnet_params_to_jax(named(m.params), len(m.net)),
            alexnet_params_to_jax(named(m.opt_state["velocity"]),
                                  len(m.net)))


def _assert_close(port_tree, ref_tree):
    ref_tree = jax.tree.map(np.array, ref_tree)
    for a, b in zip(jax.tree.leaves(jax.tree.map(
            lambda t: t.detach().numpy(), port_tree)),
            jax.tree.leaves(ref_tree)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_reference_save_resumes_in_the_port(tmp_path):
    jm = _ref_model()
    _ref_step(jm, 0)
    jm.current_epoch = 3
    path = jm.save_model(str(tmp_path / "ref.npz"))
    m = AlexNet(config=dict(CFG), device="cpu")
    m.load_model(path)
    assert m.current_epoch == 3 and m.opt_state["step"] == 1
    np.testing.assert_array_equal(m.rng, np.asarray(jm.rng))
    loss_ref, loss = _ref_step(jm, 1), _port_step(m, 1)
    assert abs(loss - loss_ref) <= ATOL
    params, vel = _port_tree(m)
    _assert_close(params, jm.params)
    _assert_close(vel, jm.opt_state["velocity"])


def test_port_save_resumes_in_the_reference(tmp_path):
    m = AlexNet(config=dict(CFG), device="cpu")
    # the reference's initial weights, so that the loss is O(1) as in
    # the other direction (the port's own init starts near 16)
    m.load_state_dict(alexnet_params_from_jax(
        jax.tree.map(np.array, _ref_model().params)))
    _port_step(m, 0)
    m.current_epoch = 2
    path = m.save_model(str(tmp_path / "port.npz"))
    jm = _ref_model()
    jm.load_model(path)
    assert jm.current_epoch == 2 and int(jm.opt_state["step"]) == 1
    loss, loss_ref = _port_step(m, 1), _ref_step(jm, 1)
    assert abs(loss - loss_ref) <= ATOL
    params, vel = _port_tree(m)
    _assert_close(params, jm.params)
    _assert_close(vel, jm.opt_state["velocity"])


@pytest.fixture(scope="module")
def port_model_file(tmp_path_factory):
    m = AlexNet(config=dict(CFG), device="cpu")
    return m, m.save_model(str(tmp_path_factory.mktemp("ck") / "port.npz"))


@pytest.fixture
def port_file(port_model_file):
    return port_model_file[1]


def test_the_port_file_is_the_reference_tree(tmp_path, port_model_file):
    """Same keys, structure, shapes and dtypes as the reference's own
    file; the port's generator states under one extra key."""
    m, path = port_model_file
    mine = ckpt.restore(path)
    theirs = ref_ckpt.restore(_ref_model().save_model(str(tmp_path / "r.npz")))
    assert set(mine) == set(theirs) | {"torch_state"}
    for key in theirs:
        assert (jax.tree.structure(mine[key]) == jax.tree.structure(
            theirs[key])), key
        for a, b in zip(jax.tree.leaves(mine[key]),
                        jax.tree.leaves(theirs[key])):
            assert np.shape(a) == np.shape(b)
            assert np.asarray(a).dtype == np.asarray(b).dtype, key
    np.testing.assert_array_equal(
        alexnet_params_from_jax(mine["params"])["net.0.w"],
        m.params[0].detach())


def test_error_feedback_residuals_keep_the_reference_layout(tmp_path,
                                                             capsys):
    over = dict(exch_strategy="int8", error_feedback=True)
    m = AlexNet(config=dict(CFG, **over), device="cpu")
    _port_step(m, 0)
    # at a world of 1 the wire is exact and the residuals stay zero:
    # give them values to carry
    gen = torch.Generator().manual_seed(0)
    for e in m.opt_state["ef_wire"]:
        e.copy_(torch.randn(e.shape, generator=gen))
    path = m.save_model(str(tmp_path / "ef.npz"))
    jm = _ref_model(**over)
    jm.compile_train()  # creates the reference's residuals
    mine = ckpt.restore(path)["opt_state"]["ef_wire"]
    assert jax.tree.structure(mine) == jax.tree.structure(
        jm.opt_state["ef_wire"])
    for a, b in zip(jax.tree.leaves(mine),
                    jax.tree.leaves(jm.opt_state["ef_wire"])):
        assert a.shape == b.shape and a.shape[0] == 1
    jm.load_model(path)
    assert "ef_wire" in jm.opt_state  # kept: same world, EF on
    # back into the port: the residuals of rank 0
    m2 = AlexNet(config=dict(CFG, **over), device="cpu")
    m2.load_model(path)
    for a, b in zip(m2.opt_state["ef_wire"], m.opt_state["ef_wire"]):
        assert torch.equal(a, b)
    # dropped where the reference drops them, with its messages
    AlexNet(config=dict(CFG), device="cpu").load_model(path)
    assert ("dropping ef_wire residuals: this model has "
            "error_feedback=False") in capsys.readouterr().out
    blob = ckpt.restore(path)
    blob["opt_state"]["ef_wire"] = jax.tree.map(
        lambda a: np.concatenate([a, a]), blob["opt_state"]["ef_wire"])
    two = ckpt.save(str(tmp_path / "ef2.npz"), blob)
    m3 = AlexNet(config=dict(CFG, **over), device="cpu")
    m3.load_model(two)
    assert "ef_wire" not in m3.opt_state
    assert "checkpoint world 2 != this group's 1" in capsys.readouterr().out


@pytest.mark.parametrize("damage,match", [
    (lambda b: b["params"][0].pop("b"), "different params structure"),
    (lambda b: b["params"].append({}), "different params structure"),
    (lambda b: b["opt_state"]["velocity"][0].update(
        w=np.zeros((2, 2), np.float32)), "different optimizer-state layout"),
    (lambda b: b["opt_state"].update(nu=np.zeros(3, np.float32)),
     "different optimizer-state layout"),
])
def test_refusals_match_the_reference(tmp_path, port_file, damage, match):
    blob = ckpt.restore(port_file)
    damage(blob)
    path = ckpt.save(str(tmp_path / "bad.npz"), blob)
    with pytest.raises(ValueError) as got:
        AlexNet(config=dict(CFG), device="cpu").load_model(path)
    with pytest.raises(ValueError) as want:
        _ref_model().load_model(path)
    assert match in str(got.value)
    assert str(got.value) == str(want.value)


def test_reference_file_seeds_the_generators_from_its_rng_words(tmp_path):
    jm = _ref_model(seed=7)
    path = jm.save_model(str(tmp_path / "ref.npz"))
    m = AlexNet(config=dict(CFG), device="cpu")  # seed 0
    m.load_model(path)
    want = AlexNet(config=dict(CFG, seed=7), device="cpu")
    words = np.asarray(jm.rng)
    seeded = (int(words[0]) << 32) | int(words[1])
    want._seed_generators(seeded)
    assert torch.equal(m.generator.get_state(), want.generator.get_state())
    assert torch.equal(m.wire_generator.get_state(),
                       want.wire_generator.get_state())


LM_CFG = dict(batch_size=4, seq_len=32, vocab_size=32, d_model=32,
              n_heads=4, n_layers=2, n_synth_train=8, n_synth_val=1,
              comm_probe=False, seed=3)


def test_transformer_files_load_both_ways(tmp_path):
    """The LM's nested per-layer dicts (no transposes) round-trip
    reference → port → reference bit for bit."""
    jm = JaxLM(config=dict(LM_CFG), mesh=make_mesh(devices=jax.devices()[:1]))
    want = jax.tree.map(np.array, jm.params)
    m = TransformerLM(config=dict(LM_CFG, seed=4), device="cpu")
    m.load_model(jm.save_model(str(tmp_path / "ref.npz")))
    state = m.state_dict()
    for name, t in params_from_jax(want).items():
        assert torch.equal(state[name], t), name
    back = JaxLM(config=dict(LM_CFG, seed=5),
                           mesh=make_mesh(devices=jax.devices()[:1]))
    back.load_model(m.save_model(str(tmp_path / "port.npz")))
    assert jax.tree.structure(back.params) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(want)):
        assert np.asarray(a).tobytes() == b.tobytes()

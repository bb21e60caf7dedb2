"""The port's AlexNet against the reference's, on the CPU.

The reference ``AlexNet`` (``lrn_impl='pallas'``, ``pool_grad='pallas'``,
``dropout_rate=0``) is built on a one-device mesh at a small size
(64 px, batch 2, 10 classes; every layer width as published); its
parameters are converted into the port's model
(``convert.alexnet_params_from_jax``) and the same seeded batch goes
through both.

Tolerances:

- fp32 step: loss atol 1e-5, error exact, every updated parameter and
  velocity atol 1e-6 (velocities are ≤ 1e-2 here; measured ≤ 2e-8).
  TF32 plays no part on the CPU.
- bf16 step: loss atol 1e-3; every updated parameter and velocity
  within 10 % of the reference's in norm, ‖Δ‖/‖ref‖ ≤ 0.1 (measured
  0.03).  Each framework sums the fp32 convolutions in its own order
  before narrowing to bf16; the first conv already differs by a bf16
  step on 1 output in 8 000, by conv5 on 1 in 10, and the gradients of
  every layer under the head carry it.  The dense chain alone, fed the
  same bf16 input, agrees to 7e-5 in norm.
- layer forwards (fp32): rtol 1e-5, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theanompi_tpu.ops.pallas_lrn as pallas_lrn
import theanompi_tpu.ops.pallas_pool as pallas_pool
from theanompi_tpu.models.alex_net import AlexNet as JaxAlexNet
from theanompi_tpu.ops import layers as JL
from theanompi_tpu.ops import optim as jax_optim
from theanompi_tpu.runtime.mesh import make_mesh, shard_batch
from theanompi_tpu_torch.convert import alexnet_params_from_jax
from theanompi_tpu_torch.models.alex_net import AlexNet
from theanompi_tpu_torch.ops import layers as L
from theanompi_tpu_torch.ops import optim

CFG = dict(image_size=64, batch_size=2, n_classes=10, lrn_impl="pallas",
           pool_grad="pallas", dropout_rate=0.0, n_synth_batches=1,
           comm_probe=False, print_freq=10_000)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 10, 2).astype(np.int32)
    return x, y


def _reference_step(compute_dtype, monkeypatch):
    """One ``compile_train`` step of the reference; returns the numpy
    params before, after, the velocity after, loss and error."""
    calls = {"lrn": 0, "pool": 0}
    real_lrn, real_pool = pallas_lrn._rowblock_call, pallas_pool.maxpool_bwd

    def spy_lrn(*a, **kw):
        calls["lrn"] += 1
        return real_lrn(*a, **kw)

    def spy_pool(*a, **kw):
        calls["pool"] += 1
        return real_pool(*a, **kw)

    monkeypatch.setattr(pallas_lrn, "_rowblock_call", spy_lrn)
    monkeypatch.setattr(pallas_pool, "maxpool_bwd", spy_pool)
    mesh = make_mesh(devices=jax.devices()[:1])
    jm = JaxAlexNet(config=dict(CFG, compute_dtype=compute_dtype), mesh=mesh)
    before = jax.tree.map(np.array, jm.params)
    x, y = _batch()
    xs, ys = shard_batch(mesh, (x, y))
    out = jm.compile_train()(jm.params, jm.net_state, jm.opt_state, xs, ys,
                             jax.random.PRNGKey(1))
    # traced once: 2 LRN forwards + 2 backwards, 3 pool backwards
    assert calls == {"lrn": 4, "pool": 3}, calls
    return dict(
        before=before,
        after=jax.tree.map(np.array, out[0]),
        velocity=jax.tree.map(np.array, out[2]["velocity"]),
        loss=float(out[3]), err=float(out[4]),
    )


@pytest.fixture(scope="module")
def mp():
    m = pytest.MonkeyPatch()
    yield m
    m.undo()


@pytest.fixture(scope="module")
def ref_fp32(mp):
    return _reference_step(None, mp)


@pytest.fixture(scope="module")
def ref_bf16(mp):
    return _reference_step("bfloat16", mp)


def _port_step(ref, compute_dtype):
    m = AlexNet(config=dict(CFG, compute_dtype=compute_dtype), device="cpu")
    m.load_state_dict(alexnet_params_from_jax(ref["before"]))
    x, y = _batch()
    loss, err = m.compile_train()(torch.tensor(x), torch.tensor(y))
    vel = {f"net.{n}": v for n, v in zip(m.param_names,
                                         m.opt_state["velocity"])}
    return m, float(loss), float(err), m.state_dict(), vel


def test_convert_transposes_conv_weights_only(ref_fp32):
    params = ref_fp32["before"]
    state = alexnet_params_from_jax(params)
    m = AlexNet(config=dict(CFG), device="cpu")
    want = m.state_dict()
    assert set(state) == set(want)
    for k, t in state.items():
        assert t.shape == want[k].shape, k
    w = params[0]["w"]  # HWIO (11, 11, 3, 96)
    np.testing.assert_array_equal(state["net.0.w"].numpy()[5, 2, 7, 1],
                                  w[7, 1, 2, 5])
    np.testing.assert_array_equal(state["net.16.w"].numpy(), params[16]["w"])


def test_stem_same_padding_is_asymmetric_at_128px():
    assert L.explicit_padding("SAME", (11, 11), (4, 4), (128, 128)) == (
        (3, 4), (3, 4))
    rng = np.random.RandomState(3)
    x = rng.randn(1, 128, 128, 3).astype(np.float32)
    ref = JL.Conv2d(96, 11, stride=4, padding="SAME")
    p, _, shape = ref.init(jax.random.PRNGKey(0), (128, 128, 3))
    conv = L.Conv2d(3, 96, 11, stride=4, padding="SAME")
    state = alexnet_params_from_jax([jax.tree.map(np.array, p)])
    conv.load_state_dict({"w": state["net.0.w"], "b": state["net.0.b"]})
    assert conv.out_shape((128, 128, 3)) == shape == (32, 32, 96)
    y = conv(torch.tensor(x))
    y_ref = np.asarray(ref.apply(p, {}, jnp.asarray(x))[0])
    assert y.is_contiguous() and tuple(y.shape) == (1, 32, 32, 96)
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=1e-5,
                               atol=1e-5)


def test_each_layer_forward_matches_reference(ref_fp32):
    params = ref_fp32["before"]
    m = AlexNet(config=dict(CFG), device="cpu")
    m.load_state_dict(alexnet_params_from_jax(params))
    ref_net = _reference_net()
    x = jnp.asarray(_batch()[0])
    for i, (layer, mod) in enumerate(zip(ref_net.layers, m.net)):
        p_i = {k: jnp.array(v) for k, v in params[i].items()}
        y_ref = layer.apply(p_i, {}, x)[0]
        y = mod(torch.tensor(np.asarray(x)))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"layer {i} {type(mod).__name__}")
        x = y_ref


def _reference_net():
    mesh = make_mesh(devices=jax.devices()[:1])
    return JaxAlexNet(config=dict(CFG), mesh=mesh).net


def test_train_step_matches_reference_fp32(ref_fp32):
    m, loss, err, state, vel = _port_step(ref_fp32, None)
    assert abs(loss - ref_fp32["loss"]) <= 1e-5
    assert err == ref_fp32["err"]
    after = alexnet_params_from_jax(ref_fp32["after"])
    v_ref = alexnet_params_from_jax(ref_fp32["velocity"])
    for k in after:
        np.testing.assert_allclose(state[k].numpy(), after[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(vel[k].numpy(), v_ref[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_train_step_matches_reference_bf16(ref_bf16):
    m, loss, err, state, vel = _port_step(ref_bf16, "bfloat16")
    assert abs(loss - ref_bf16["loss"]) <= 1e-3
    after = alexnet_params_from_jax(ref_bf16["after"])
    before = alexnet_params_from_jax(ref_bf16["before"])
    v_ref = alexnet_params_from_jax(ref_bf16["velocity"])
    for k in after:
        step_ref = after[k] - before[k]
        rel = float((state[k] - before[k] - step_ref).norm()
                    / step_ref.norm())
        assert rel <= 0.1, (k, rel)
        rel_v = float((vel[k] - v_ref[k]).norm() / v_ref[k].norm())
        assert rel_v <= 0.1, (k, rel_v)


def test_lr_schedule_follows_reference_through_adjust_hyperp(ref_fp32):
    m = AlexNet(config=dict(CFG, lr_boundaries=(2, 4, 5)), device="cpu")
    sched = jax_optim.step_decay(0.01, [2, 4, 5], 0.1)
    for epoch in range(7):
        m.adjust_hyperp(epoch)
        assert optim.get_lr(m.opt_state) == pytest.approx(sched(epoch),
                                                          rel=1e-12)
    m.scale_lr(4.0)
    assert optim.get_lr(m.opt_state) == pytest.approx(4 * sched(6))


def test_unported_settings_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        AlexNet(config=dict(CFG, stem="s2d"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        AlexNet(config=dict(CFG, grad_accum=2), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        AlexNet(config=dict(CFG, optimizer="adam"), device="cpu")


@pytest.mark.parametrize("name,args", [
    ("constant", (0.1,)),
    ("step_decay", (0.1, [2, 4], 0.5)),
    ("exp_decay", (0.1, 0.9)),
    ("linear_warmup_step", (0.1, 3, [5, 7], 0.1)),
])
def test_lr_schedules_equal_reference(name, args):
    mine, ref = getattr(optim, name)(*args), getattr(jax_optim, name)(*args)
    for epoch in range(10):
        assert mine(epoch) == pytest.approx(ref(epoch), rel=1e-15)

"""The port's TransformerLM training slice against the reference's, on
the CPU.

The reference ``TransformerLM`` is built on a one-device mesh with the
config of ``tests/test_flash.py``'s flash LM test (d_model 32, 4 heads,
2 layers, seq_len 32, vocab 32, batch 4, ``exch_strategy='ar'``, weight
decay 0; the reference's lr 0.1 and momentum 0.9), with
``attn_impl='flash'`` (the Pallas kernels, interpret mode) or
``'xla'``.  Its parameters are converted into the port's model
(``convert.params_from_jax``) and the same provider batch goes through
one ``compile_train`` step on both sides.

Tolerances:

- fp32 step: loss atol 1e-5, error exact, every updated parameter and
  velocity atol 1e-6 (both compute in fp32; the frameworks sum in other
  orders, the reference's softmax runs online over blocks; the
  embedding gradient is a scatter-add, summed in another order).  The
  validation step's loss atol 1e-5, errors exact.
- bf16 step: loss atol 1e-3; every updated parameter and velocity
  within 5 % of the reference's in norm (‖Δ‖/‖ref‖ ≤ 0.05).  Each
  framework rounds its fp32 products to bf16 where the code says so, but
  XLA:CPU's fused programs move some of those roundings, and a bf16
  step in the residual stream reaches every gradient.
"""

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.data.providers import LMTextData as JaxLMTextData
from theanompi_tpu.models.transformer import TransformerLM as JaxLM
from theanompi_tpu.ops import optim as jax_optim
from theanompi_tpu.runtime.mesh import make_mesh, shard_batch
from theanompi_tpu_torch import BSP
from theanompi_tpu_torch.convert import params_from_jax
from theanompi_tpu_torch.data.providers import LMTextData
from theanompi_tpu_torch.models.transformer import TransformerLM
from theanompi_tpu_torch.ops import flash as FL
from theanompi_tpu_torch.ops import optim

CFG = dict(
    batch_size=4, seq_len=32, vocab_size=32, d_model=32, n_heads=4,
    n_layers=2, n_synth_train=8, n_synth_val=1, print_freq=10_000,
    weight_decay=0.0, exch_strategy="ar", comm_probe=False, seed=3,
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Leave the CPU to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch():
    data = LMTextData(batch_size=4, seq_len=32, vocab_size=32,
                      n_synth_train=8, n_synth_val=1, seed=3)
    data.shuffle(0)
    return next(iter(data.train_batches()))


def _reference_step(attn_impl, compute_dtype, **over):
    mesh = make_mesh(devices=jax.devices()[:1])
    jm = JaxLM(config=dict(CFG, attn_impl=attn_impl,
                           compute_dtype=compute_dtype, **over), mesh=mesh)
    before = jax.tree.map(np.array, jm.params)
    x, y = _batch()
    xs, ys = shard_batch(mesh, (x, y))
    # the validation step first: the train step donates the params
    val = jm.compile_val()(jm.params, jm.net_state, xs, ys)
    out = jm.compile_train()(jm.params, jm.net_state, jm.opt_state, xs, ys,
                             jax.random.PRNGKey(1))
    return dict(
        before=before,
        after=params_from_jax(jax.tree.map(np.array, out[0])),
        velocity=params_from_jax(
            jax.tree.map(np.array, out[2]["velocity"])),
        loss=float(out[3]), err=float(out[4]),
        val=[float(a) for a in val],
    )


@pytest.fixture(scope="module")
def ref_flash():
    return _reference_step("flash", None)


@pytest.fixture(scope="module")
def ref_flash_bf16():
    return _reference_step("flash", "bfloat16")


@pytest.fixture(scope="module")
def ref_xla():
    return _reference_step("xla", None)


def _port_step(ref, attn_impl, compute_dtype, **over):
    m = TransformerLM(config=dict(CFG, attn_impl=attn_impl,
                                  compute_dtype=compute_dtype, **over),
                      device="cpu")
    m.load_state_dict(params_from_jax(ref["before"]))
    x, y = (torch.from_numpy(a) for a in _batch())
    val = [float(a) for a in m.compile_val()(x, y)]
    loss, err = m.compile_train()(x, y)
    vel = {f"net.{n}": v for n, v in zip(m.param_names,
                                         m.opt_state["velocity"])}
    return dict(loss=float(loss), err=float(err), state=m.state_dict(),
                velocity=vel, val=val)


def test_lm_text_data_matches_reference():
    kw = dict(batch_size=4, seq_len=16, vocab_size=32, n_synth_train=6,
              n_synth_val=2, seed=5)
    mine, ref = LMTextData(**kw), JaxLMTextData(**kw)
    assert (mine.n_batch_train, mine.n_batch_val) == (
        ref.n_batch_train, ref.n_batch_val)
    for epoch in (0, 1, None):
        mine.shuffle(epoch)
        ref.shuffle(epoch)
        for a, b in zip(mine.train_batches(), ref.train_batches(),
                        strict=True):
            for u, w in zip(a, b):
                assert u.dtype == w.dtype == np.int32
                np.testing.assert_array_equal(u, w)
    for a, b in zip(mine.val_batches(), ref.val_batches(), strict=True):
        np.testing.assert_array_equal(np.stack(a), np.stack(b))
    mine.shard_for_worker(1, 2)
    ref.shard_for_worker(1, 2)
    mine.shuffle(3)
    ref.shuffle(3)
    assert mine.n_batch_train == ref.n_batch_train
    for a, b in zip(mine.train_batches(), ref.train_batches(), strict=True):
        np.testing.assert_array_equal(np.stack(a), np.stack(b))
    with pytest.raises(ValueError, match="outside"):
        mine.shard_for_worker(2, 2)


def _assert_step_equal(got, ref):
    assert abs(got["loss"] - ref["loss"]) <= 1e-5
    assert got["err"] == ref["err"]
    np.testing.assert_allclose(got["val"], ref["val"], rtol=0, atol=1e-5)
    assert got["val"][1:] == ref["val"][1:]
    for k, want in ref["after"].items():
        np.testing.assert_allclose(got["state"][k].numpy(), want.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["velocity"][k].numpy(),
                                   ref["velocity"][k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_flash_train_step_matches_reference_fp32(ref_flash):
    _assert_step_equal(_port_step(ref_flash, "flash", None), ref_flash)


def test_xla_train_step_matches_reference_fp32(ref_xla):
    _assert_step_equal(_port_step(ref_xla, "xla", None), ref_xla)


def test_flash_train_step_head_dim_144_matches_reference_fp32():
    """A head wider than the CUDA kernels' 128 trains on the CPU with
    ``attn_impl='flash'``, as in the reference (d_model 288, 2 heads)."""
    wide = dict(d_model=288, n_heads=2)
    ref = _reference_step("flash", None, **wide)
    _assert_step_equal(_port_step(ref, "flash", None, **wide), ref)


def test_flash_train_step_matches_reference_bf16(ref_flash_bf16):
    ref = ref_flash_bf16
    got = _port_step(ref, "flash", "bfloat16")
    assert abs(got["loss"] - ref["loss"]) <= 1e-3
    before = params_from_jax(ref["before"])
    for k, want in ref["after"].items():
        step_ref = want - before[k]
        rel = float((got["state"][k] - before[k] - step_ref).norm()
                    / step_ref.norm())
        assert rel <= 0.05, (k, rel)
        v_ref = ref["velocity"][k]
        rel_v = float((got["velocity"][k] - v_ref).norm() / v_ref.norm())
        assert rel_v <= 0.05, (k, rel_v)


def test_bsp_trains_on_the_cpu_through_the_plain_versions():
    """The reference's entry point, on the CPU: the loss falls, the
    validation runs, and no kernel is launched."""
    launches = (FL.flash_fwd.launches, FL.flash_dq.launches,
                FL.flash_dkv.launches)
    rule = BSP()
    rule.init(devices=1, modelfile="theanompi_tpu_torch.models.transformer",
              modelclass="TransformerLM",
              model_config=dict(CFG, attn_impl="flash", n_epochs=2,
                                print_freq=4), device="cpu")
    model = rule.wait()
    rec = rule.worker.recorder
    costs = [r["cost"] for r in rec.history]
    assert len(costs) == 2 * model.data.n_batch_train // 4
    assert all(np.isfinite(costs)) and costs[-1] < costs[0]
    assert len(rec.val_history) == 2
    assert (FL.flash_fwd.launches, FL.flash_dq.launches,
            FL.flash_dkv.launches) == launches


def test_lr_schedule_follows_reference():
    m = TransformerLM(config=dict(CFG), device="cpu")
    sched = jax_optim.step_decay(0.1, [3], 0.1)
    for epoch in range(5):
        m.adjust_hyperp(epoch)
        assert optim.get_lr(m.opt_state) == pytest.approx(sched(epoch),
                                                          rel=1e-12)


@pytest.mark.parametrize("key,value,exc,item", [
    ("remat", True, NotImplementedError, "ROADMAP A12"),
    ("sp", 2, ValueError, "sp=2"),
    ("tp", 2, ValueError, "ROADMAP A13"),
    ("pp", 2, ValueError, "pp=2"),
    ("moe_experts", 4, ValueError, "moe_experts"),
    ("exchange_overlap", "indag", NotImplementedError, "ROADMAP A9"),
    ("attn_impl", "pallas", ValueError, "attn_impl"),
])
def test_unported_keys_raise(key, value, exc, item):
    with pytest.raises(exc, match=item):
        TransformerLM(config=dict(CFG, **{key: value}), device="cpu")


def test_default_block_strategy_raises_at_compile():
    """The reference's default wire, int8_sr, is the default and
    compiles; what still raises at compile is the reference's own scope
    check: error feedback over a lossless or cast wire, or under avg."""
    cfg = {k: v for k, v in CFG.items() if k != "exch_strategy"}
    m = TransformerLM(config=cfg, device="cpu")
    assert m.config.exch_strategy == "int8_sr"
    x, y = (torch.from_numpy(a) for a in _batch())
    loss, _ = m.compile_train()(x, y)
    assert m.exchanger.strategy == "int8_sr" and np.isfinite(float(loss))
    for over in (dict(exch_strategy="ar"), dict(exch_strategy="bf16"),
                 dict(sync_mode="avg")):
        m = TransformerLM(config=dict(cfg, error_feedback=True, **over),
                          device="cpu")
        with pytest.raises(ValueError, match="error_feedback"):
            m.compile_train()

"""BSP data parallelism of the port against the reference.

Two gloo ranks (separate processes, ``runtime.dist`` over ``env://``)
each take their half of a global batch of 4 (rows [r·2, (r+1)·2)) and
run one ``compile_train`` step of AlexNet (64 px, 10 classes, fp32,
``lrn_impl='pallas'``, ``pool_grad='pallas'``, dropout 0); the
reference runs the same global batch on a two-device mesh.  Wires:
``ar`` and the ``bf16`` cast wire, both bucketed with 1 MB buckets
(several buckets, small leaves fused with their neighbours).

Tolerances: ``ar`` — loss atol 1e-5, parameters and velocities atol
1e-6 (fp32; measured ~1e-8).  ``bf16`` — the rank gradients differ
from the reference's by ~1e-8 before the wire rounds them to bf16, so
a rounding may fall the other way: per leaf, max |Δ| ≤ 2⁻⁷ · max
|velocity| (one bf16 step at the leaf's scale) for both parameters and
velocities.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.models.alex_net import AlexNet as JaxAlexNet
from theanompi_tpu.runtime.mesh import make_mesh, shard_batch
from theanompi_tpu_torch import BSP
from theanompi_tpu_torch.convert import alexnet_params_from_jax
from theanompi_tpu_torch.models.alex_net import AlexNet
from theanompi_tpu_torch.parallel import bucketing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(image_size=64, batch_size=2, n_classes=10, lrn_impl="pallas",
           pool_grad="pallas", dropout_rate=0.0, n_synth_batches=1,
           comm_probe=False, print_freq=10_000, exchange_bucket_mb=1.0)
STRATEGIES = ("ar", "bf16")

RANK_MAIN = r"""
import os, sys
import numpy as np, torch
from theanompi_tpu_torch.data.loader import rank_rows
from theanompi_tpu_torch.models.alex_net import AlexNet
inp, out, cfg = sys.argv[1], sys.argv[2], eval(sys.argv[3])
blob = torch.load(inp)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
x, y = rank_rows((blob["x"].numpy(), blob["y"].numpy()), rank, world)
res = {}
for strategy in blob["strategies"]:
    m = AlexNet(config=dict(cfg, exch_strategy=strategy), device="cpu")
    assert (m.rank, m.n_workers, m.world.backend) == (rank, world, "gloo")
    m.load_state_dict(blob["state"])
    loss, err = m.compile_train()(torch.tensor(x), torch.tensor(y))
    res[strategy] = dict(loss=float(loss), err=float(err),
                         state=m.state_dict(),
                         velocity={"net." + n: v for n, v in zip(
                             m.param_names, m.opt_state["velocity"])})
if rank == 0:
    torch.save(res, out)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _global_batch():
    rng = np.random.RandomState(5)
    return (rng.randn(4, 64, 64, 3).astype(np.float32),
            rng.randint(0, 10, 4).astype(np.int32))


@pytest.fixture(scope="module")
def reference():
    mesh = make_mesh(devices=jax.devices()[:2])
    x, y = _global_batch()
    out = {}
    before = None
    for strategy in STRATEGIES:
        jm = JaxAlexNet(config=dict(CFG, exch_strategy=strategy), mesh=mesh)
        assert jm.global_batch == 4
        before = jax.tree.map(np.array, jm.params)
        xs, ys = shard_batch(mesh, (x, y))
        r = jm.compile_train()(jm.params, jm.net_state, jm.opt_state, xs, ys,
                               jax.random.PRNGKey(2))
        out[strategy] = dict(
            loss=float(r[3]),
            after=alexnet_params_from_jax(jax.tree.map(np.array, r[0])),
            velocity=alexnet_params_from_jax(
                jax.tree.map(np.array, r[2]["velocity"])))
    return before, out


@pytest.fixture(scope="module")
def two_ranks(reference, tmp_path_factory):
    before, _ = reference
    d = tmp_path_factory.mktemp("bsp")
    inp, out = d / "in.pt", d / "out.pt"
    x, y = _global_batch()
    torch.save(dict(x=torch.tensor(x), y=torch.tensor(y),
                    strategies=STRATEGIES,
                    state=alexnet_params_from_jax(before)), inp)
    env = dict(os.environ, PYTHONPATH=ROOT, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="2")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, str(inp), str(out), repr(CFG)],
            cwd=ROOT, env=dict(env, RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return torch.load(out)


def test_bucket_plan_has_several_buckets_and_fuses_small_leaves():
    m_names = [f"{i}.{k}" for i in (0, 4, 8, 10, 12, 16, 19, 22)
               for k in ("w", "b")]
    m = AlexNet(config=dict(CFG), device="cpu")
    shapes = tuple((tuple(p.shape), str(p.dtype)) for p in m.params)
    plan = bucketing.cached_plan(
        tuple(m.param_names), shapes, (("dp",),) * len(shapes), "ar",
        int(CFG["exchange_bucket_mb"] * (1 << 20)))
    assert sorted(m.param_names) == sorted(m_names)
    assert len(plan.buckets) > 1
    assert max(len(b.idx) for b in plan.buckets) > 1
    assert sorted(i for b in plan.buckets for i in b.idx) == list(
        range(len(m.params)))


def test_two_gloo_ranks_ar_match_reference_two_device_mesh(reference,
                                                           two_ranks):
    ref, got = reference[1]["ar"], two_ranks["ar"]
    assert abs(got["loss"] - ref["loss"]) <= 1e-5
    for k in ref["after"]:
        np.testing.assert_allclose(got["state"][k].numpy(),
                                   ref["after"][k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["velocity"][k].numpy(),
                                   ref["velocity"][k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_two_gloo_ranks_bf16_wire_match_reference(reference, two_ranks):
    ref, got = reference[1]["bf16"], two_ranks["bf16"]
    assert abs(got["loss"] - ref["loss"]) <= 1e-5
    for k in ref["after"]:
        step = 2.0 ** -7 * float(ref["velocity"][k].abs().max())
        np.testing.assert_allclose(got["state"][k].numpy(),
                                   ref["after"][k].numpy(), rtol=0,
                                   atol=step, err_msg=k)
        np.testing.assert_allclose(got["velocity"][k].numpy(),
                                   ref["velocity"][k].numpy(), rtol=0,
                                   atol=step, err_msg=k)


def test_bsp_rule_trains_one_short_epoch_on_the_cpu():
    rule = BSP()
    rule.init(devices=1, modelfile="theanompi_tpu_torch.models.alex_net",
              modelclass="AlexNet", device="cpu",
              model_config=dict(CFG, compute_dtype="bfloat16",
                                dropout_rate=0.5, n_synth_batches=3,
                                n_epochs=1, print_freq=1, batch_size=4))
    model = rule.wait()
    rec = rule.worker.recorder
    assert model.current_epoch == 1 and len(rec.history) == 3
    assert all(np.isfinite(r["cost"]) for r in rec.history)
    assert len(rec.val_history) == 1 and np.isfinite(
        rec.val_history[0]["cost"])
    assert rec.totals["calc"] > 0


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AlexNet(config=dict(CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BSP().init(devices=1, model_config=dict(CFG))


def test_alexnet_preset_matches_reference_and_runs():
    from theanompi_tpu.presets import PRESETS as JAX_PRESETS
    from theanompi_tpu_torch.presets import PRESETS, run_preset

    mine, ref = PRESETS["alexnet-bsp"], JAX_PRESETS["alexnet-bsp"]
    assert mine["model_config"] == ref["model_config"]
    assert mine["rule_kwargs"] == ref["rule_kwargs"]
    assert (mine["rule"], mine["modelclass"]) == (ref["rule"],
                                                  ref["modelclass"])
    with pytest.raises(NotImplementedError, match="--spawn-procs 8"):
        run_preset("alexnet-bsp", dict(CFG), device="cpu")  # 8 ranks
    model = run_preset("alexnet-bsp", dict(CFG, n_epochs=1), devices=1,
                       device="cpu", val_freq=0)
    assert model.current_epoch == 1 and model.compute_dtype == torch.bfloat16

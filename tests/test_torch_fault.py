"""The port's fault tools against the reference's, and resume after a
crash.

``theanompi_tpu_torch.runtime.fault`` is a copy of
``theanompi_tpu.runtime.fault``: every test here drives both with the
same plans and inputs and requires the same outcomes (raised or not,
the same messages, the same sleeps, the same exit codes).  The
watchdog's timing checks use the reference's own margins
(``tests/test_fault.py``: a 0.3 s timeout against 1 s of silence, ticks
every 0.08 s against 0.5 s).

The restart test trains the port's AlexNet (64 px, batch 2, 10 classes,
fp32, dropout 0, mirror on) at a world of 1 on the CPU for 2 epochs of
2 steps with a snapshot per epoch: the first attempt crashes at the
first step of the second epoch, ``run_with_restart`` starts a second
attempt with ``resume=True``, which must start at epoch 1 (not 0) and
finish; its final parameters and velocities must equal an uninterrupted
run's bit for bit (tolerance 0).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import theanompi_tpu.runtime.fault as ref
import theanompi_tpu_torch.runtime.fault as port
from theanompi_tpu_torch import BSP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(image_size=64, batch_size=2, n_classes=10, lrn_impl="pallas",
           pool_grad="pallas", dropout_rate=0.0, n_synth_batches=2,
           n_epochs=2, print_freq=10_000, compute_dtype=None)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Leave the CPU to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _drive(mod, plan, calls, monkeypatch):
    """Outcomes of ``maybe_fail`` over ``calls`` (rank, iteration), with
    ``time.sleep`` recorded instead of slept."""
    slept = []
    monkeypatch.setattr(mod.time, "sleep", slept.append)
    fi = mod.FaultInjector(plan)
    out = []
    for rank, it in calls:
        try:
            fi.maybe_fail(rank, it)
            out.append("ok")
        except mod.TrainingFault as e:
            out.append(f"raise {e}")
    monkeypatch.undo()
    return out, slept


PLANS = [
    [(0, 3)],
    [(0, 2, "raise"), (1, 2, "hang", 0.5), (1, 4, "slow", 0.01)],
    [(2, 1, "slow"), (0, 1, "hang"), (0, 3)],
]
CALLS = [(r, i) for i in range(1, 6) for r in range(3)] + [(0, 3), (1, 2)]


@pytest.mark.parametrize("plan", PLANS)
def test_fault_injector_matches_reference(plan, monkeypatch):
    assert (_drive(port, plan, CALLS, monkeypatch)
            == _drive(ref, plan, CALLS, monkeypatch))


@pytest.mark.parametrize("spec", [
    "", "raise@0:3", "kill@1:40;slow@2:10:0.05", " hang@0:2:1.5 ; raise@1:7 ;",
    "slow@0:1;slow@1:1:0.2",
])
@pytest.mark.parametrize("rank", [None, 0, 1])
def test_fault_plan_from_env_matches_reference(spec, rank):
    env = {"THEANOMPI_FAULT_PLAN": spec}
    a = port.FaultInjector.from_env(rank=rank, env=env)
    b = ref.FaultInjector.from_env(rank=rank, env=env)
    assert (a is None) == (b is None)
    if a is not None:
        assert a._plan == b._plan


@pytest.mark.parametrize("spec", ["raise@x:1", "raise@0", "boom@0:1"])
def test_bad_fault_plans_raise_as_the_reference(spec):
    env = {"THEANOMPI_FAULT_PLAN": spec}
    with pytest.raises(ValueError) as want:
        ref.FaultInjector.from_env(env=env)
    with pytest.raises(ValueError) as got:
        port.FaultInjector.from_env(env=env)
    assert str(got.value) == str(want.value)


def test_exit_codes_are_the_reference_s():
    assert port.FaultInjector.KILL_EXIT_CODE == ref.FaultInjector.KILL_EXIT_CODE
    assert port.Watchdog.EXIT_CODE == ref.Watchdog.EXIT_CODE == 86
    assert port.FaultInjector.MODES == ref.FaultInjector.MODES


def _run_port(code: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))


def test_kill_mode_exits_with_the_reference_s_code():
    proc = _run_port(
        "from theanompi_tpu_torch.runtime.fault import FaultInjector\n"
        "FaultInjector([(0, 1, 'kill')]).maybe_fail(0, 1)\n"
        "print('not reached')\n")
    assert proc.returncode == ref.FaultInjector.KILL_EXIT_CODE, proc.stderr
    assert "not reached" not in proc.stdout
    assert "FAULT: killing rank 0 at iter 1" in proc.stderr


@pytest.mark.parametrize("action", ["dump", "exit", "restart"])
def test_watchdog_action_check_matches_reference(action):
    def outcome(mod):
        try:
            return mod.Watchdog.validate_action(action)
        except ValueError as e:
            return str(e)

    assert outcome(port) == outcome(ref)


def test_watchdog_maybe_is_none_for_no_timeout_and_arms_on_first_tick():
    assert port.Watchdog.maybe(None) is None and port.Watchdog.maybe(0) is None
    wd = port.Watchdog.maybe(5.0)
    try:
        assert not wd._armed and wd.action == "dump"
        wd.tick()
        assert wd._armed
    finally:
        wd.close()


def test_watchdog_stall_fires_and_dumps(capfd):
    stalls = []
    wd = port.Watchdog(timeout_s=0.3, poll_s=0.05, on_stall=stalls.append)
    try:
        time.sleep(1.0)  # no ticks: it must fire at least once
    finally:
        wd.close()
    assert stalls and stalls[0] >= 0.3
    err = capfd.readouterr().err
    assert "WATCHDOG" in err and "thread stacks follow" in err


def test_watchdog_ticks_and_pause_keep_it_quiet():
    stalls = []
    wd = port.Watchdog(timeout_s=0.5, poll_s=0.05, on_stall=stalls.append)
    try:
        for _ in range(12):
            wd.tick()
            time.sleep(0.08)  # always inside the window
        with wd.pause():
            time.sleep(1.0)  # a long phase, paused
    finally:
        wd.close()
    assert not stalls


def test_watchdog_exit_mode_terminates_process():
    proc = _run_port(
        "import time\n"
        "from theanompi_tpu_torch.runtime.fault import Watchdog\n"
        "Watchdog(timeout_s=0.3, poll_s=0.05, action='exit')\n"
        "time.sleep(30)\n")
    assert proc.returncode == 86, proc.stderr
    assert "WATCHDOG" in proc.stderr


def _restart_trace(mod, fail_at, max_restarts, error=None):
    calls, failures = [], []

    def fn(attempt):
        calls.append(attempt)
        if attempt in fail_at:
            raise (error or mod.TrainingFault)(f"boom {attempt}")

    try:
        out = mod.run_with_restart(
            fn, max_restarts=max_restarts,
            on_failure=lambda a, e: failures.append((a, str(e))))
    except BaseException as e:  # noqa: BLE001 — the outcome is compared
        out = f"{type(e).__name__}: {e}"
    return out, calls, failures


@pytest.mark.parametrize("fail_at,max_restarts", [
    ((), 0), ((0, 1), 3), ((0, 1, 2), 2), ((0,), 0), ((1,), 1)])
def test_run_with_restart_matches_reference(fail_at, max_restarts, capsys):
    assert (_restart_trace(port, fail_at, max_restarts)
            == _restart_trace(ref, fail_at, max_restarts))


def test_run_with_restart_never_restarts_an_operator_abort():
    for mod in (port, ref):
        out, calls, _ = _restart_trace(mod, (0,), 3, KeyboardInterrupt)
        assert out.startswith("KeyboardInterrupt") and calls == [0]


def _final_state(model):
    return ([p.detach().clone() for p in model.params],
            [v.clone() for v in model.opt_state["velocity"]])


@pytest.fixture(scope="module")
def uninterrupted():
    rule = BSP().init(devices=1, model_config=dict(CFG), device="cpu")
    return _final_state(rule.wait())


def test_restart_resumes_at_epoch_1_and_equals_an_uninterrupted_run(
        tmp_path, uninterrupted):
    epochs, done = [], []
    model = None

    def attempt(i):
        nonlocal model
        rule = BSP().init(devices=1, model_config=dict(CFG), device="cpu",
                          checkpoint_dir=str(tmp_path), resume=i > 0)
        model = rule.model
        real_adjust = model.adjust_hyperp
        model.adjust_hyperp = lambda e: (epochs.append((i, e)),
                                         real_adjust(e))
        if i == 0:
            # crash at the first step of the second epoch, after the
            # first epoch's snapshot
            plan = port.FaultInjector([(0, CFG["n_synth_batches"] + 1)])
            real = model.train_iter

            def train_iter(count, rec):
                plan.maybe_fail(model.rank, count)
                return real(count, rec)

            model.train_iter = train_iter
        rule.wait()
        done.append((i, model.current_epoch))

    assert port.run_with_restart(attempt, max_restarts=1) == 1
    # the first attempt crashed in epoch 1; the second resumed there
    assert epochs == [(0, 0), (0, 1), (1, 1)] and done == [(1, 2)]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_0001.npz", "ckpt_0002.npz",
                                            "record_rank0.jsonl"]
    params, vel = _final_state(model)
    for got, want in zip(params + vel, uninterrupted[0] + uninterrupted[1]):
        assert torch.equal(got, want)


def test_resume_prints_and_starts_at_the_saved_epoch(tmp_path, capsys):
    cfg = dict(CFG, n_epochs=1, n_synth_batches=1)
    BSP().init(devices=1, model_config=cfg, device="cpu",
               checkpoint_dir=str(tmp_path), val_freq=0).wait()
    rule = BSP().init(devices=1, model_config=dict(cfg, n_epochs=2),
                      device="cpu", checkpoint_dir=str(tmp_path),
                      resume=True, val_freq=0)
    seen = []
    real = rule.model.adjust_hyperp
    rule.model.adjust_hyperp = lambda e: (seen.append(e), real(e))
    rule.wait()
    assert seen == [1]
    out = capsys.readouterr().out
    assert f"resumed from {tmp_path / 'ckpt_0001.npz'} at epoch 1" in out
    assert np.isfinite(rule.worker.recorder.history[-1]["cost"])

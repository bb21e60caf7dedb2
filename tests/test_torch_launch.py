"""``python -m theanompi_tpu_torch.launch`` against the reference's
launcher.

- The parser's BSP flags have the reference's names, defaults and
  choices (the default model file named in the port's package).
- ``--preset`` resolves as the reference resolves it: explicit flags
  win, ``--config`` JSON is merged over the preset's config; both
  launchers are run with their rule replaced by a recorder, and the
  kwargs handed to ``rule.init`` are compared.
- Every refusal, each naming its ROADMAP item (``--wire-dtype``: the
  reference's own message).
- ``--restarts`` resumes every attempt after the first;
  ``--dist-*`` become the ``env://`` variables.
- A tiny AlexNet (64 px, batch 2, 10 classes) trains through ``main``
  on the CPU and leaves ``ckpt_*.npz`` files that the reference's
  ``checkpoint.restore`` reads to the port's tree (exact); and through
  ``--spawn-procs 2 --device cpu`` over gloo with the ``int8`` wire and
  error feedback: one checkpoint, written by rank 0, whose ``ef_wire``
  has a leading axis of 2, and parameters bitwise equal across the
  ranks (their SHA-1 in each rank's record).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import theanompi_tpu
import theanompi_tpu.launch as ref_launch
import theanompi_tpu.utils.checkpoint as ref_ckpt
from theanompi_tpu_torch import launch
from theanompi_tpu_torch.parallel import rules
from theanompi_tpu_torch.runtime import multiprocess
from theanompi_tpu_torch.runtime.recorder import Recorder
from theanompi_tpu_torch.utils import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=64, batch_size=2, n_classes=10, n_synth_batches=2,
            n_epochs=2, print_freq=1, lrn_impl="pallas", pool_grad="pallas")
# the flags the reference's BSP path reads (async-rule knobs excluded)
BSP_DESTS = ("rule", "modelfile", "modelclass", "preset", "devices",
             "config", "checkpoint_dir", "resume", "keep_last",
             "watchdog_timeout", "watchdog_action", "restarts",
             "spawn_procs", "spawn_local_devices", "dist_coordinator",
             "dist_nprocs", "dist_rank", "wire_dtype", "elastic_restarts",
             "late_join")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Leave the CPU to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _actions(parser):
    return {a.dest: a for a in parser._actions}


@pytest.mark.parametrize("dest", BSP_DESTS)
def test_parser_flags_and_defaults_are_the_reference_s(dest):
    mine = _actions(launch.build_parser())[dest]
    ref = _actions(ref_launch.build_parser())[dest]
    assert mine.option_strings == ref.option_strings
    want = ref.default
    if dest == "modelfile":
        want = want.replace("theanompi_tpu.", "theanompi_tpu_torch.", 1)
    assert mine.default == want
    assert mine.choices == ref.choices
    assert mine.type == ref.type or dest == "keep_last"
    assert type(mine).__name__ == type(ref).__name__


def test_parser_refuses_abbreviations_and_keep_last_0(capsys):
    p = launch.build_parser()
    assert not p.allow_abbrev
    for argv in (["--checkpoint", "d"], ["--keep-last", "0"]):
        with pytest.raises(SystemExit):
            p.parse_args(argv)
    assert launch.build_parser().parse_args([]).device is None


class _Recorded:
    """Stands in for a rule: records what ``init`` got."""

    calls = []
    fail_first = False

    def init(self, **kw):
        type(self).calls.append(kw)
        return self

    def wait(self):
        if type(self).fail_first and len(type(self).calls) == 1:
            raise RuntimeError("injected crash")


@pytest.fixture
def recorded(monkeypatch):
    _Recorded.calls, _Recorded.fail_first = [], False
    monkeypatch.setattr(rules, "BSP", _Recorded)
    monkeypatch.setattr(theanompi_tpu, "BSP", _Recorded)
    monkeypatch.setattr(os, "environ", dict(os.environ))
    return _Recorded


PRESET_ARGS = [
    ["--preset", "alexnet-bsp"],
    ["--preset", "alexnet-bsp", "--devices", "1", "--config",
     '{"lr": 0.1, "compute_dtype": null}'],
    ["--preset", "alexnet-bsp", "--modelclass", "AlexNet",
     "--checkpoint-dir=/tmp/x", "--keep-last", "2", "--resume",
     "--watchdog-timeout", "30", "--watchdog-action", "exit"],
]


@pytest.mark.parametrize("argv", PRESET_ARGS)
def test_preset_resolution_matches_the_reference(recorded, argv):
    assert launch.main(argv) == 0
    mine = recorded.calls.pop()
    assert ref_launch.main(argv) == 0
    ref = recorded.calls.pop()
    assert mine.pop("device") is None  # the card unless --device cpu
    ref["modelfile"] = ref["modelfile"].replace(
        "theanompi_tpu.", "theanompi_tpu_torch.", 1)
    assert mine == ref
    given = (json.loads(argv[argv.index("--config") + 1])
             if "--config" in argv else {})
    assert mine["model_config"]["compute_dtype"] == given.get(
        "compute_dtype", "bfloat16")
    assert mine["devices"] == int(given and 1 or 8)


def test_restarts_resume_every_later_attempt(recorded, capfd):
    recorded.fail_first = True
    argv = ["--preset", "alexnet-bsp", "--devices", "1", "--restarts", "1",
            "--checkpoint-dir", "d", "--device", "cpu"]
    assert launch.main(argv) == 0
    assert [c["resume"] for c in recorded.calls] == [False, True]
    assert recorded.calls[0]["device"] == "cpu"
    assert "restart 1/1" in capfd.readouterr().out
    recorded.calls.clear()
    with pytest.raises(RuntimeError, match="injected crash"):
        launch.main(["--preset", "alexnet-bsp", "--devices", "1"])


def test_dist_flags_become_the_env_variables(recorded):
    launch.main(["--preset", "alexnet-bsp", "--devices", "2",
                 "--dist-coordinator", "host0:1234", "--dist-nprocs", "2",
                 "--dist-rank", "1"])
    assert {k: os.environ[k] for k in (
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")} == dict(
            MASTER_ADDR="host0", MASTER_PORT="1234", WORLD_SIZE="2",
            RANK="1")
    with pytest.raises(SystemExit, match="--dist-rank and --dist-nprocs"):
        launch.main(["--preset", "alexnet-bsp", "--dist-coordinator", "h:1"])


@pytest.mark.parametrize("argv,match", [
    (["--rule", "EASGD"], "ROADMAP A10"),
    (["--rule", "GOSGD"], "ROADMAP A10"),
    (["--rule", "BSP_ELASTIC"], "ROADMAP A11"),
    (["--elastic-restarts", "1"], "ROADMAP A11"),
    (["--late-join", "1:0.5"], "ROADMAP A11"),
    (["--spawn-local-devices", "2"], "one process is one rank"),
    (["--modelfile", "theanompi_tpu.models.alex_net"],
     "the JAX reference's module"),
    ([], "ROADMAP A4"),
])
def test_refusals_name_their_roadmap_item(recorded, argv, match):
    with pytest.raises(SystemExit, match=match):
        launch.main(argv)
    assert recorded.calls == []


def test_wire_dtype_refusal_is_the_reference_s(recorded):
    argv = ["--preset", "alexnet-bsp", "--wire-dtype", "float16"]
    with pytest.raises(SystemExit) as want:
        ref_launch.main(argv)
    with pytest.raises(SystemExit) as got:
        launch.main(argv)
    assert str(got.value) == str(want.value) and recorded.calls == []


@pytest.mark.parametrize("name,item", [
    ("wresnet-smoke", "A8"), ("googlenet-bsp", "A8"), ("vgg16-bsp", "A8"),
    ("resnet50-easgd", "A10"), ("lsgan-gosgd", "A10")])
def test_unported_presets_name_their_roadmap_item(recorded, name, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        launch.main(["--preset", name])
    with pytest.raises(KeyError, match="unknown preset"):
        launch.main(["--preset", "nope"])


def test_spawn_local_fails_fast_with_the_exit_codes():
    with pytest.raises(RuntimeError, match=r"exit codes \[1, 1\]"):
        multiprocess.spawn_local(2, ["--rule", "EASGD"], stream_output=False,
                                 timeout=120)


def test_main_trains_and_leaves_checkpoints_the_reference_reads(tmp_path,
                                                               capfd):
    d = tmp_path / "run"
    assert launch.main([
        "--preset", "alexnet-bsp", "--devices", "1", "--device", "cpu",
        "--config", json.dumps(TINY), "--checkpoint-dir", str(d)]) == 0
    assert sorted(os.listdir(d)) == ["ckpt_0001.npz", "ckpt_0002.npz",
                                     "record_rank0.jsonl"]
    for name in ("ckpt_0001.npz", "ckpt_0002.npz"):
        mine, theirs = ckpt.restore(str(d / name)), ref_ckpt.restore(
            str(d / name))
        assert jax.tree.structure(mine) == jax.tree.structure(theirs)
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert theirs["epoch"] == 2 and int(theirs["opt_state"]["step"]) == 4
    rows = Recorder.load(str(d / "record_rank0.jsonl"))
    assert [r["epoch"] for r in rows if r["kind"] == "epoch"] == [0, 1]
    assert len([r for r in rows if r["kind"] == "train"]) == 4
    assert "AlexNet: " in capfd.readouterr().out


def test_spawn_procs_2_on_the_cpu(tmp_path):
    d = tmp_path / "run"
    cfg = dict(TINY, n_epochs=1, compute_dtype=None, exch_strategy="int8",
               error_feedback=True)
    proc = subprocess.run(
        [sys.executable, "-m", "theanompi_tpu_torch.launch", "--preset",
         "alexnet-bsp", "--devices", "2", "--spawn-procs", "2", "--device",
         "cpu", "--config", json.dumps(cfg), "--checkpoint-dir", str(d)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert sorted(os.listdir(d)) == ["ckpt_0001.npz", "record_rank0.jsonl",
                                     "record_rank1.jsonl"]
    blob = ref_ckpt.restore(str(d / "ckpt_0001.npz"))
    ef = jax.tree.leaves(blob["opt_state"]["ef_wire"])
    assert ef and all(a.shape[0] == 2 for a in ef)
    assert blob["torch_state"]["world"] == 2
    digests = [[r["sha1"] for r in Recorder.load(
        str(d / f"record_rank{k}.jsonl")) if r["kind"] == "params"]
        for k in (0, 1)]
    assert len(digests[0]) == 1 and digests[0] == digests[1]
    assert "gloo world of 2 on cpu" in proc.stdout

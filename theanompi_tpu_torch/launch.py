"""CLI launcher — ``python -m theanompi_tpu_torch.launch``, the
counterpart of ``python -m theanompi_tpu.launch`` for the BSP rule.

One process is one rank on one device; it runs on the card unless
``--device cpu`` is given.  Examples::

    # AlexNet-128 (bf16) on one card, snapshots every epoch, resumed
    # from the newest one after a crash
    python -m theanompi_tpu_torch.launch --preset alexnet-bsp --devices 1 \\
        --checkpoint-dir ./run0 --keep-last 2 --restarts 2

    # two ranks on this machine (the reference's mpirun -np 2): NCCL
    # with a card each, gloo when they share one
    python -m theanompi_tpu_torch.launch --preset alexnet-bsp --devices 2 \\
        --spawn-procs 2

    # one command per process, group addressed explicitly
    python -m theanompi_tpu_torch.launch --preset alexnet-bsp --devices 2 \\
        --dist-coordinator host0:1234 --dist-nprocs 2 --dist-rank 0

``--preset`` fills rule, model and config; flags given explicitly win,
and ``--config`` JSON is merged over the preset's config.  ``--resume``
starts from the newest ``ckpt_*.npz`` of ``--checkpoint-dir``;
``--restarts N`` re-runs a crashed attempt up to N times, each one
resuming.  Refused, each with the ROADMAP item that ports it: the
EASGD and GOSGD rules (A10), the elastic tier (``BSP_ELASTIC``,
``--elastic-restarts``, ``--late-join``: A11); and, as the reference
refuses it for BSP, ``--wire-dtype`` other than float32.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

DEFAULT_MODELFILE = "theanompi_tpu_torch.models.cifar10"
DEFAULT_MODELCLASS = "Cifar10_model"
# flags that only the spawning parent reads
_PARENT_FLAGS = ("--spawn-procs", "--spawn-local-devices")


def build_parser() -> argparse.ArgumentParser:
    # allow_abbrev=False: preset resolution compares the raw argv flag
    # names to find what the user set explicitly
    p = argparse.ArgumentParser(
        prog="theanompi_tpu_torch.launch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        allow_abbrev=False)
    p.add_argument("--rule", choices=["BSP", "BSP_ELASTIC", "EASGD", "GOSGD"],
                   default="BSP",
                   help="BSP; the others are not ported yet (EASGD, "
                   "GOSGD: ROADMAP A10; BSP_ELASTIC: A11)")
    p.add_argument("--modelfile", default=DEFAULT_MODELFILE)
    p.add_argument("--modelclass", default=DEFAULT_MODELCLASS)
    p.add_argument("--preset", default=None,
                   help="a BASELINE.json target config by name (see "
                   "presets.PRESETS); sets rule/model/config defaults, "
                   "explicit flags still override")
    p.add_argument("--devices", type=int, default=None,
                   help="number of ranks (default: this process's world)")
    p.add_argument("--config", default="{}", help="model config JSON")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action="store_true")

    def _positive(v):
        n = int(v)
        if n < 1:  # fail at parse time, not at the first prune
            raise argparse.ArgumentTypeError("--keep-last must be >= 1")
        return n

    p.add_argument("--keep-last", type=_positive, default=None, metavar="N",
                   help="prune checkpoints to the newest N after each save "
                   "(default: keep all)")
    p.add_argument("--watchdog-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="stall watchdog: fire when no training iteration "
                   "completes within this window")
    p.add_argument("--watchdog-action", choices=["dump", "exit"],
                   default="dump",
                   help="on stall: 'dump' thread stacks and keep watching, "
                   "or 'exit' the process (code 86) so a supervisor "
                   "restarts it")
    p.add_argument("--restarts", type=int, default=0,
                   help="restart-from-checkpoint budget on crash (0 = fail "
                   "fast)")
    p.add_argument("--spawn-procs", type=int, default=None,
                   help="start N local processes, one rank each, joined "
                   "into one group (runtime.multiprocess.spawn_local)")
    p.add_argument("--spawn-local-devices", type=int, default=1,
                   help="devices per spawned process: 1 (one process is "
                   "one rank on one device)")
    p.add_argument("--dist-coordinator", default=None, metavar="HOST:PORT",
                   help="address of rank 0's store (MASTER_ADDR:"
                   "MASTER_PORT of env://)")
    p.add_argument("--dist-nprocs", type=int, default=None)
    p.add_argument("--dist-rank", type=int, default=None)
    p.add_argument("--wire-dtype", choices=["float32", "float16", "q8"],
                   default="float32",
                   help="the async rules' payload dtype; BSP compresses "
                   "through exch_strategy in --config")
    p.add_argument("--elastic-restarts", type=int, default=None,
                   metavar="N", help="elastic supervision (ROADMAP A11)")
    p.add_argument("--late-join", default=None,
                   metavar="RANK:DELAY[,RANK:DELAY]",
                   help="late-joining ranks (ROADMAP A11)")
    p.add_argument("--device", default=None,
                   help="'cpu' runs on the CPU (gloo); default: the card")
    return p


def _refuse(args) -> None:
    if args.rule in ("EASGD", "GOSGD"):
        raise SystemExit(f"--rule {args.rule} is not ported yet (ROADMAP "
                         "A10); this launcher runs BSP")
    if (args.rule == "BSP_ELASTIC" or args.elastic_restarts is not None
            or args.late_join):
        raise SystemExit("the elastic tier (--rule BSP_ELASTIC, "
                         "--elastic-restarts, --late-join) is not ported "
                         "yet (ROADMAP A11)")
    if args.wire_dtype != "float32":
        raise SystemExit(
            "--wire-dtype applies to the --dist-* EASGD/GOSGD paths; "
            "for BSP use exch_strategy (bf16/int8/...) in --config")
    if args.spawn_local_devices != 1:
        raise SystemExit(
            f"--spawn-local-devices {args.spawn_local_devices}: one process "
            "is one rank on one device here; start N ranks with "
            "--spawn-procs N")
    if args.modelfile.split(".")[0] == "theanompi_tpu":
        raise SystemExit(
            f"--modelfile {args.modelfile} is the JAX reference's module; "
            "the port's models are theanompi_tpu_torch.models.*")
    if (args.modelfile, args.modelclass) == (DEFAULT_MODELFILE,
                                             DEFAULT_MODELCLASS):
        raise SystemExit(
            "the default model, Cifar10_model, is not ported yet (ROADMAP "
            "A4): pass --preset alexnet-bsp, or --modelfile "
            "theanompi_tpu_torch.models.alex_net --modelclass AlexNet")


def _child_argv(argv) -> list:
    """argv less the spawning parent's own flags (both ``--flag value``
    and ``--flag=value``): a child must not spawn again."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in _PARENT_FLAGS:
            skip = True
            continue
        if a.startswith(tuple(f + "=" for f in _PARENT_FLAGS)):
            continue
        out.append(a)
    return out


def main(argv=None) -> int:
    # a hard crash in a launched process must leave its tracebacks
    import faulthandler

    faulthandler.enable()
    argv_list = list(argv if argv is not None else sys.argv[1:])
    args = build_parser().parse_args(argv_list)

    if args.preset:
        from theanompi_tpu_torch.presets import get_preset

        spec = get_preset(args.preset)
        given = {a.split("=", 1)[0] for a in argv_list if a.startswith("--")}
        if "--rule" not in given:
            args.rule = spec["rule"]
        if "--modelfile" not in given:
            args.modelfile = spec["modelfile"]
        if "--modelclass" not in given:
            args.modelclass = spec["modelclass"]
        cfg = dict(spec["model_config"])
        cfg.update(json.loads(args.config))  # explicit JSON wins
        args.config = json.dumps(cfg)
        for k, v in spec["rule_kwargs"].items():
            if "--" + k.replace("_", "-") not in given:
                setattr(args, k, v)
    _refuse(args)

    if args.spawn_procs:
        from theanompi_tpu_torch.runtime.multiprocess import spawn_local

        spawn_local(args.spawn_procs, _child_argv(argv_list))
        return 0

    if args.dist_coordinator is not None:
        if args.dist_nprocs is None or args.dist_rank is None:
            raise SystemExit("--dist-rank and --dist-nprocs are required "
                             "with --dist-coordinator")
        host, _, port = args.dist_coordinator.rpartition(":")
        os.environ.update(MASTER_ADDR=host or "127.0.0.1", MASTER_PORT=port,
                          WORLD_SIZE=str(args.dist_nprocs),
                          RANK=str(args.dist_rank))

    from theanompi_tpu_torch.parallel.rules import BSP
    from theanompi_tpu_torch.runtime.fault import run_with_restart

    model_config = json.loads(args.config)

    def attempt(i: int) -> None:
        kw = dict(checkpoint_dir=args.checkpoint_dir,
                  resume=args.resume or i > 0)
        if args.keep_last:
            kw["keep_last"] = args.keep_last
        if args.watchdog_timeout:
            kw.update(watchdog_timeout=args.watchdog_timeout,
                      watchdog_action=args.watchdog_action)
        rule = BSP()
        rule.init(devices=args.devices, modelfile=args.modelfile,
                  modelclass=args.modelclass,
                  model_config=dict(model_config), device=args.device, **kw)
        rule.wait()

    run_with_restart(attempt, max_restarts=args.restarts)
    return 0


if __name__ == "__main__":
    sys.exit(main())

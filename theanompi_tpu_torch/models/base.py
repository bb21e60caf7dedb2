"""Model-contract base class — counterpart of
``theanompi_tpu.models.base.TpuModel`` (same class name, so the two
are easy to find side by side).

The contract the workers consume: ``__init__(config)``,
``build_model()``, ``compile_train()``, ``compile_val()``,
``train_iter(count, recorder)``, ``val_iter``/``run_validation``,
``adjust_hyperp(epoch)``, ``scale_lr(factor)``, ``cleanup()``, and the
attributes ``params``, ``data``, ``batch_size``, ``global_batch``,
``n_epochs``.

What the port does in place of the reference's one jitted, shard-mapped
XLA step: each process is one rank of a ``torch.distributed`` group
(``runtime.dist``) holding a full replica of the model on its device;
``compile_train`` builds the step as a Python function that runs
forward and backward eagerly, reduces the gradients through
``BSP_Exchanger`` (one wire per bucket) and applies the optimizer in
place.  ``batch_size`` is per rank and the providers deliver global
batches (``batch_size × world``); rank r trains on rows ``[r·b,
(r+1)·b)``, the reference's ``dp`` sharding order.  The exchange sees
the parameters in the reference's pytree order (layer index, then the
keys sorted), so buckets and their quantization blocks hold the
elements the reference's hold.

Ported: ``sync_mode`` 'cdd' and 'avg', ``exchange_overlap`` 'bucket'
and 'leaf', every wire strategy (``ar``, the cast wires ``bf16`` /
``fp16`` and the block wires ``fp16s``, ``int8``, ``int8_sr`` and their
``pallas_*`` names), ``error_feedback`` on the block wires,
``grad_accum=1``.  The stochastic-rounding wires take two seed words
per bucket and step from a generator of their own, seeded per rank (the
reference folds the rank into its step key).  Error feedback keeps a
per-rank fp32 residual per parameter in ``opt_state['ef_wire']``, in
the exchange's order (the reference's recurrence: send ``g + residual``, keep what the wire's
first leg dropped).  Not yet (each raises with its ROADMAP item):
ZeRO-1, in-DAG issue, the two-level wire (A9), gradient accumulation
and clipping (A4), on-device augmentation (A3).

Checkpoints (``checkpoint_state``, ``save_model``, ``load_model``)
carry the reference's tree in the reference's layout (``convert``), so
a file written by either package loads in the other.  The port's own
generator states go under one more key, ``TORCH_STATE_KEY``, which the
reference ignores.  ``save_model`` is collective: every rank calls it
(rank 0 writes), because the error-feedback residuals and the
generator states of all ranks are gathered into the file.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from theanompi_tpu_torch import convert
from theanompi_tpu_torch.data.loader import prefetch_to_device
from theanompi_tpu_torch.device import DeviceLike, resolve_dtype
from theanompi_tpu_torch.ops import losses
from theanompi_tpu_torch.ops import optim as optim_lib
from theanompi_tpu_torch.ops.layers import count_params
from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
from theanompi_tpu_torch.runtime.config import Config
from theanompi_tpu_torch.runtime.dist import init_process_group

COMMON_DEFAULTS = dict(
    seed=0,
    batch_size=128,  # per data-parallel rank
    n_epochs=10,
    lr=0.01,
    momentum=0.9,
    nesterov=False,
    weight_decay=1e-4,
    sync_mode="cdd",  # 'cdd' = gradient reduce; 'avg' = param averaging
    exch_strategy="ar",  # 'ar' | 'bf16' | 'fp16' | block: 'int8_sr', …
    error_feedback=False,
    prefetch_depth=2,
    grad_clip_norm=None,
    print_freq=40,
    val_top5=True,
    compute_dtype=None,  # e.g. 'bfloat16'
    device_aug=False,
    comm_probe=True,  # accepted; the comm-fraction probe is not ported
    sync_each_iter=False,  # True = read the step's loss every step
    zero1=False,
    grad_accum=1,
    exchange_overlap="bucket",  # 'leaf' | 'bucket' ('indag': A9)
    exchange_bucket_mb=4.0,
    dcn_shape=None,
)


def _refuse_unported(cfg, n_workers: int) -> None:
    checks = {
        "zero1 (ROADMAP A9)": bool(cfg.zero1) and n_workers > 1,
        "exchange_overlap='indag' (ROADMAP A9)":
            cfg.exchange_overlap == "indag",
        "dcn_shape (ROADMAP A9)": bool(cfg.dcn_shape),
        "grad_accum > 1 (ROADMAP A4)": int(cfg.grad_accum or 1) > 1,
        "grad_clip_norm (ROADMAP A4)": cfg.grad_clip_norm is not None,
        "device_aug (ROADMAP A3)": bool(cfg.device_aug),
    }
    bad = [k for k, v in checks.items() if v]
    if bad:
        raise NotImplementedError(
            f"not ported yet: {', '.join(bad)}")
    if cfg.exchange_overlap not in ("leaf", "bucket", "indag"):
        raise ValueError(f"exchange_overlap must be leaf|bucket|indag, got "
                         f"{cfg.exchange_overlap!r}")
    if cfg.sync_mode not in ("cdd", "avg"):
        raise ValueError(
            f"sync_mode must be 'cdd' or 'avg', got {cfg.sync_mode!r}")


def _check_error_feedback(cfg) -> None:
    """The reference's scope for error feedback: a lossy block wire
    under cdd (its tp/pp and extra-axis refusals have no counterpart
    in a data-parallel-only port)."""
    unsupported = {
        "exch_strategy 'ar' (lossless wire)": cfg.exch_strategy == "ar",
        "cast wires (block strategies only)":
            cfg.exch_strategy in ("bf16", "fp16"),
        "sync_mode != 'cdd'": cfg.sync_mode != "cdd",
        "zero1": bool(cfg.zero1),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"error_feedback does not support: {', '.join(bad)}")


# the port's own state in a checkpoint (the reference ignores the key)
TORCH_STATE_KEY = "torch_state"


def _seed_words(seed: int) -> np.ndarray:
    """``seed`` as the two uint32 words of the reference's
    ``jax.random.PRNGKey(seed)`` (a checkpoint's ``rng``)."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    dtype=np.uint32)


def _leaves(tree):
    """Leaves in the reference's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _structure(tree):
    """Keys of a params tree, leaves dropped (the structure check)."""
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def _shapes(tree) -> list:
    return [tuple(np.shape(leaf)) for leaf in _leaves(tree)]


def _stack(trees: list):
    """Per-rank trees of tensors → one tree, each leaf stacked on a
    leading rank axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def _reference_order(names):
    """Indices of ``names`` (``"{layer}.{key}…"``) in the reference's
    pytree flattening order: list indices numerically, dict keys
    sorted."""
    def key(i):
        return tuple((int(p), "") if p.isdigit() else (-1, p)
                     for p in names[i].split("."))
    return sorted(range(len(names)), key=key)


class TpuModel:
    default_config: dict = {}

    def __init__(self, config: Optional[dict] = None,
                 device: DeviceLike = None, **overrides):
        self.config = Config(COMMON_DEFAULTS)
        self.config.update(self.default_config)
        if config:
            self.config.update(dict(config))
        self.config.update(overrides)
        cfg = self.config
        self.world = init_process_group(device)
        self.device = self.world.device
        self.rank = self.world.rank
        self.n_workers = self.world.size
        _refuse_unported(cfg, self.n_workers)
        self.compute_dtype = resolve_dtype(cfg.compute_dtype)
        self.batch_size = int(cfg.batch_size)
        self.global_batch = self.batch_size * self.n_workers
        self.n_epochs = int(cfg.n_epochs)
        self.generator = torch.Generator(device=self.device)
        self.wire_generator = torch.Generator()
        self._seed_generators(int(cfg.seed))
        # the reference's rng words (a checkpoint's ``rng``); the port
        # draws from its own generators and does not advance them
        self.rng = _seed_words(int(cfg.seed))
        self.data = None
        self.net: Optional[nn.Module] = None
        self.input_shape: Optional[Tuple[int, ...]] = None
        self.lr_schedule = optim_lib.constant(float(cfg.lr))
        self._lr_scale = 1.0
        self.build_data()
        self.build_model()
        self.train_fn = None
        self.val_fn = None
        self.exchanger = None
        self._train_it = None
        self._val_it = None
        self.current_epoch = 0

    def _seed_generators(self, seed: int) -> None:
        # one stream per rank (the reference folds the rank into its
        # step key), in the 63 bits a generator's seed takes
        per_rank = (seed * 1_000_003 + self.rank) % (1 << 63)
        self.generator.manual_seed(per_rank)  # dropout masks
        # stochastic-rounding seed words of the wire
        self.wire_generator.manual_seed(per_rank ^ 0x5EED_0000_0000)

    # the reference's params list ↔ this net's state (``convert``)
    params_to_reference = staticmethod(convert.params_to_jax)
    params_from_reference = staticmethod(convert.params_from_jax)

    # ---- subclass hooks ---------------------------------------------------
    def build_data(self) -> None:
        raise NotImplementedError

    def build_net(self) -> Tuple[nn.Module, Tuple[int, ...]]:
        raise NotImplementedError

    # ---- contract: build_model ------------------------------------------
    def build_model(self) -> None:
        cfg = self.config
        self.net, self.input_shape = self.build_net()
        self.net.to(self.device)
        gen = torch.Generator().manual_seed(int(cfg.seed))
        for m in self.net.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        self.param_names = [n for n, _ in self.net.named_parameters()]
        self.params = [p for _, p in self.net.named_parameters()]
        self.exchange_order = _reference_order(self.param_names)
        self.optimizer = optim_lib.from_config(cfg)
        self.opt_state = self.optimizer.init(self.params)
        self.n_params = count_params(self.net)

    def state_dict(self) -> dict:
        """Parameters as ``net.{i}.{w,b}`` (the reference's
        ``params[i]``; see ``convert``)."""
        return {f"net.{k}": v for k, v in self.net.state_dict().items()}

    def load_state_dict(self, state: dict) -> None:
        """Load ``net.{i}.…`` parameters (e.g. from ``convert``), copied
        to the model's device; the optimizer state is left as it is."""
        bad = [k for k in state if not k.startswith("net.")]
        if bad:
            raise KeyError(f"expected keys 'net.…', got {bad[:3]}")
        self.net.load_state_dict({k[4:]: v for k, v in state.items()})

    # ---- loss -----------------------------------------------------------
    def _cast_input(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype) if self.compute_dtype else x

    def _metrics(self, logits, y):
        err = losses.classification_error(logits, y)
        if self.config.val_top5 and logits.shape[-1] > 5:
            return err, losses.topk_error(logits, y, k=5)
        return err, err

    def loss_and_metrics(self, x, y, train: bool):
        self.net.train(train)
        logits = self.net(self._cast_input(x))
        loss = losses.softmax_cross_entropy(logits, y)
        err, err5 = self._metrics(logits.detach(), y)
        return loss, (err, err5)

    def _mean_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        if self.n_workers > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.world.group)
            t = t / self.n_workers
        return t

    # ---- contract: compile_train / compile_val --------------------------
    def compile_train(self):
        """Build the training step ``train_fn(x, y) -> (loss, err)``:
        forward + backward, the exchange (with the error-feedback
        residual when configured), the optimizer update (in place).
        Loss and error are the means over the ranks, as device scalars
        (no host sync)."""
        cfg = self.config
        ef = bool(cfg.error_feedback)
        if ef:
            _check_error_feedback(cfg)
            if "ef_wire" not in self.opt_state:
                self.opt_state["ef_wire"] = [
                    torch.zeros_like(self.params[i], dtype=torch.float32)
                    for i in self.exchange_order]
        else:
            self.opt_state.pop("ef_wire", None)
        bucket_bytes = (None if cfg.exchange_overlap == "leaf" else
                        int(float(cfg.exchange_bucket_mb) * (1 << 20)))
        exchanger = BSP_Exchanger(
            strategy=cfg.exch_strategy, group=self.world.group,
            bucket_bytes=bucket_bytes)
        params, order = self.params, self.exchange_order
        ex_params = [params[i] for i in order]
        names = [self.param_names[i] for i in order]
        n_wires = len(exchanger.unit_sizes(ex_params, names))
        opt, avg = self.optimizer, cfg.sync_mode == "avg"

        def seeds():
            """Two uint32 words per wire for this rank and call."""
            if not exchanger.needs_seeds:
                return None
            return torch.randint(0, 1 << 32, (n_wires, 2),
                                 generator=self.wire_generator).tolist()

        def in_param_order(ex):
            out = [None] * len(params)
            for k, i in enumerate(order):
                out[i] = ex[k]
            return out

        def train_fn(x, y):
            loss, (err, _) = self.loss_and_metrics(x, y, True)
            grads = torch.autograd.grad(loss, params)
            if not avg:
                g = [grads[i] for i in order]
                if ef:
                    res = self.opt_state["ef_wire"]
                    send = [gi.float() + e for gi, e in zip(g, res)]
                    g, rt = exchanger.reduce_with_residual(send, names,
                                                           seeds())
                    for e, s_, r in zip(res, send, rt):
                        e.copy_(s_ - r)
                else:
                    g = exchanger.reduce_grads(g, names, seeds())
                opt.update(params, in_param_order(g), self.opt_state)
            else:
                opt.update(params, grads, self.opt_state)
                with torch.no_grad():
                    for p, a in zip(ex_params, exchanger.average_params(
                            ex_params, names, seeds())):
                        p.copy_(a)
                    vel = [self.opt_state["velocity"][i] for i in order]
                    for v, a in zip(vel, exchanger.average_params(
                            vel, names, seeds())):
                        v.copy_(a)
            m = self._mean_over_ranks(torch.stack([loss.detach(), err]))
            return m[0], m[1]

        self.train_fn = train_fn
        self.exchanger = exchanger
        return train_fn

    def compile_val(self):
        def val_fn(x, y):
            with torch.no_grad():
                loss, (err, err5) = self.loss_and_metrics(x, y, False)
                m = self._mean_over_ranks(torch.stack([loss, err, err5]))
            return m[0], m[1], m[2]

        self.val_fn = val_fn
        return val_fn

    # ---- contract: train_iter / val_iter --------------------------------
    def _loader(self, batches, depth: int):
        return prefetch_to_device(batches, self.device, self.rank,
                                  self.n_workers, depth=depth)

    def reset_train_iter(self, epoch: int) -> None:
        self.data.shuffle(epoch)
        self._train_it = self._loader(self.data.train_batches(),
                                      int(self.config.prefetch_depth))

    def reset_val_iter(self) -> None:
        self._val_it = self._loader(self.data.val_batches(), 1)

    def train_iter(self, count: int, recorder):
        if self.train_fn is None:
            self.compile_train()
        if self._train_it is None:
            self.reset_train_iter(self.current_epoch)
        recorder.start("wait")
        x, y = next(self._train_it)
        recorder.end("wait")
        recorder.start("calc")
        loss, err = self.train_fn(x, y)
        if self.config.sync_each_iter:
            loss, err = float(loss), float(err)
        recorder.end("calc")
        recorder.train_error(count, loss, err)
        return loss, err

    def val_iter(self, count: int, recorder):
        if self.val_fn is None:
            self.compile_val()
        x, y = next(self._val_it)
        return self.val_fn(x, y)

    def run_validation(self, count: int, recorder):
        """Full-set validation; one host read at the end."""
        if not self.data.n_batch_val:
            return float("nan"), float("nan"), float("nan")
        if self.val_fn is None:
            self.compile_val()
        self.reset_val_iter()
        tot = torch.zeros(3, device=self.device)
        for _ in range(self.data.n_batch_val):
            tot += torch.stack(self.val_iter(count, recorder))
        loss, err, err5 = (tot / self.data.n_batch_val).tolist()
        recorder.val_error(count, loss, err, err5)
        recorder.print_val_info(count)
        return loss, err, err5

    # ---- contract: hyperparameter scheduling ----------------------------
    def adjust_hyperp(self, epoch: int) -> None:
        """Per-epoch lr schedule (reference: shared-var lr set)."""
        self.current_epoch = epoch
        optim_lib.set_lr(self.opt_state,
                         self.lr_schedule(epoch) * self._lr_scale)

    def scale_lr(self, factor: float) -> None:
        """Linear lr scaling for N workers (reference: ``scale_lr``)."""
        self._lr_scale = float(factor)
        optim_lib.set_lr(
            self.opt_state,
            self.lr_schedule(self.current_epoch) * self._lr_scale)

    # ---- checkpoint -----------------------------------------------------
    def _reference_tree(self, tensors) -> List[dict]:
        """Per-parameter tensors (this net's order) → the reference's
        params list and layout."""
        named = {f"net.{n}": t.detach()
                 for n, t in zip(self.param_names, tensors)}
        return self.params_to_reference(named, len(self.net))

    def _from_reference_tree(self, tree) -> List[torch.Tensor]:
        """The reference's params list (numpy leaves) → fp32 CPU tensors
        in this net's order."""
        named = self.params_from_reference(tree)
        return [named[f"net.{n}"] for n in self.param_names]

    def _gather(self, obj) -> list:
        """``obj`` of every rank, in rank order (collective)."""
        if self.n_workers == 1:
            return [obj]
        out = [None] * self.n_workers
        dist.all_gather_object(out, obj, group=self.world.group)
        return out

    def _ef_reference(self):
        """Every rank's error-feedback residuals as the reference keeps
        them: the params tree, each leaf with a leading ``world`` axis
        (collective: the residuals are gathered from all ranks)."""
        order, ef = self.exchange_order, self.opt_state["ef_wire"]
        flat = torch.cat([e.reshape(-1) for e in ef])
        if self.n_workers == 1:
            rows = [flat]
        else:
            out = flat.new_empty(self.n_workers * flat.numel())
            dist.all_gather_into_tensor(out, flat, group=self.world.group)
            rows = out.view(self.n_workers, -1).unbind(0)
        trees = []
        for row in rows:
            mine: List[Optional[torch.Tensor]] = [None] * len(self.params)
            for j, piece in enumerate(row.split([e.numel() for e in ef])):
                mine[order[j]] = piece.view(ef[j].shape)
            trees.append(self._reference_tree(mine))
        return _stack(trees)

    def checkpoint_state(self) -> dict:
        """The training-state tree a checkpoint carries: the reference's
        ``params`` (list of per-layer dicts, reference layout),
        ``net_state``, ``opt_state`` (``velocity`` in the same layout,
        ``lr`` fp32, ``step`` int32, ``ef_wire`` with a leading
        ``world`` axis under error feedback), ``epoch`` and ``rng``;
        and under ``TORCH_STATE_KEY`` this port's generator states (every
        rank's dropout and wire generators, the data provider's
        shuffling/augmentation state).  Collective when the world is
        larger than 1: every rank calls it."""
        opt = {
            "velocity": self._reference_tree(self.opt_state["velocity"]),
            "lr": np.asarray(self.opt_state["lr"], np.float32),
            "step": np.asarray(self.opt_state["step"], np.int32),
        }
        if "ef_wire" in self.opt_state:
            opt["ef_wire"] = self._ef_reference()
        gens = self._gather((self.generator.get_state().numpy(),
                             self.wire_generator.get_state().numpy()))
        mine = {"world": int(self.n_workers),
                "generator": np.stack([g[0] for g in gens]),
                "wire_generator": np.stack([g[1] for g in gens])}
        data_rng = getattr(self.data, "_rng", None)
        if data_rng is not None:
            _, keys, pos, has_gauss, cached = data_rng.get_state()
            mine["data_rng"] = {"keys": keys, "pos": int(pos),
                                "has_gauss": int(has_gauss),
                                "cached_gaussian": float(cached)}
        return {
            "params": self._reference_tree(self.params),
            # no layer of the port's models keeps state beside its
            # parameters (the reference's are empty dicts too)
            "net_state": [{} for _ in range(len(self.net))],
            "opt_state": opt,
            "epoch": int(self.current_epoch),
            "rng": self.rng,
            TORCH_STATE_KEY: mine,
        }

    def save_model(self, path: str, checkpointer=None) -> str:
        """Snapshot to ``path``.  Every rank calls it (the state is
        gathered from all ranks); rank 0 writes.  With a
        ``checkpointer`` (``utils.checkpoint.AsyncCheckpointer``) the
        device→host copy happens now and the disk write on its
        thread."""
        from theanompi_tpu_torch.utils import checkpoint

        state = self.checkpoint_state()
        if self.rank != 0:
            return path
        if checkpointer is not None:
            checkpointer.save(path, state)
            return path
        return checkpoint.save(path, state)

    def load_model(self, path: str) -> None:
        """Load a checkpoint written by this port or by the reference
        (the same refusals and messages as the reference's)."""
        from theanompi_tpu_torch.utils import checkpoint

        blob = checkpoint.restore(path)
        if _structure(blob["params"]) != _structure(
                self._reference_tree(self.params)):
            raise ValueError(
                f"checkpoint {path!r} has a different params structure than "
                f"this model — an architecture config changed between save "
                "and load (e.g. GoogLeNet aux_heads, WResNet depth). "
                "Rebuild the model with the config the checkpoint was "
                "trained with."
            )
        ck_opt = blob["opt_state"]
        ck_ef = None
        if isinstance(ck_opt, dict) and "ef_wire" in ck_opt:
            ck_ef = ck_opt["ef_wire"]
            ck_opt = {k: v for k, v in ck_opt.items() if k != "ef_wire"}
        my_opt = {"velocity": self._reference_tree(self.opt_state["velocity"]),
                  "lr": 0.0, "step": 0}
        if (not isinstance(ck_opt, dict) or set(ck_opt) != set(my_opt)
                or _shapes(ck_opt) != _shapes(my_opt)):
            raise ValueError(
                f"checkpoint {path!r} has a different optimizer-state "
                "layout than this model — the optimizer or zero1 config "
                "changed between save and load (zero1 stores flat "
                "dp-sharded moments). Rebuild with the saving config."
            )
        had_ef = "ef_wire" in self.opt_state
        with torch.no_grad():
            for p, t in zip(self.params,
                            self._from_reference_tree(blob["params"])):
                p.copy_(t)
            for v, t in zip(self.opt_state["velocity"],
                            self._from_reference_tree(ck_opt["velocity"])):
                v.copy_(t)
        self.opt_state["lr"] = float(ck_opt["lr"])
        self.opt_state["step"] = int(ck_opt["step"])
        self.opt_state.pop("ef_wire", None)
        if ck_ef is not None:
            lead = int(np.shape(next(_leaves(ck_ef)))[0])
            if not bool(self.config.get("error_feedback", False)):
                print("[load_model] dropping ef_wire residuals: this model "
                      "has error_feedback=False", flush=True)
            elif lead != self.n_workers:
                print(f"[load_model] dropping ef_wire residuals: checkpoint "
                      f"world {lead} != this group's {self.n_workers}",
                      flush=True)
            else:
                from theanompi_tpu_torch.utils.checkpoint import map_tree

                row = self._from_reference_tree(
                    map_tree(lambda a: a[self.rank], ck_ef))
                self.opt_state["ef_wire"] = [
                    row[i].to(self.device) for i in self.exchange_order]
        if ("ef_wire" in self.opt_state) != had_ef:
            self.train_fn = None  # compile_train re-creates the residuals
        self.current_epoch = int(blob["epoch"])
        self.rng = np.asarray(blob["rng"], np.uint32).reshape(2)
        self._restore_generators(blob.get(TORCH_STATE_KEY), path)

    def _restore_generators(self, mine: Optional[dict], path: str) -> None:
        """This rank's generator states from the file when it was
        written by this port at this world size; otherwise (a reference
        file, another world) the generators are seeded from the file's
        ``rng`` words as ``__init__`` seeds them from ``seed``."""
        if mine is None or int(mine["world"]) != self.n_workers:
            if mine is not None:
                print(f"[load_model] {path}: generator states of a world of "
                      f"{int(mine['world'])}; seeding this world of "
                      f"{self.n_workers} from the file's rng words",
                      flush=True)
            self._seed_generators((int(self.rng[0]) << 32) | int(self.rng[1]))
            return
        self.generator.set_state(torch.from_numpy(
            np.ascontiguousarray(mine["generator"][self.rank])))
        self.wire_generator.set_state(torch.from_numpy(
            np.ascontiguousarray(mine["wire_generator"][self.rank])))
        data_rng = getattr(self.data, "_rng", None)
        if data_rng is not None and "data_rng" in mine:
            d = mine["data_rng"]
            data_rng.set_state(("MT19937", d["keys"], int(d["pos"]),
                                int(d["has_gauss"]),
                                float(d["cached_gaussian"])))

    def describe(self) -> str:
        cfg = self.config
        eff_lr = self.lr_schedule(self.current_epoch) * self._lr_scale
        lines = [
            f"{type(self).__name__}: {self.n_params:,} params, "
            f"{self.world.backend} world of {self.n_workers} on "
            f"{self.device}, global_batch={self.global_batch} "
            f"({self.batch_size}/rank x {self.n_workers})",
            f"  optimizer={cfg.get('optimizer', 'sgd')} lr={eff_lr:g} "
            f"exch={cfg.exch_strategy} sync={cfg.sync_mode}",
        ]
        if cfg.compute_dtype:
            lines.append(f"  compute_dtype={cfg.compute_dtype}")
        return "\n".join(lines)

    def cleanup(self) -> None:
        self._train_it = None
        self._val_it = None

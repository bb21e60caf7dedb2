"""theanompi_tpu_torch — the PyTorch/CUDA port of ``theanompi_tpu``.

The JAX package beside this one is the reference; this package grows
slice by slice until it does what the reference does, on an NVIDIA
Hopper card.  It imports ``torch`` and ``numpy`` and never ``jax`` or
``theanompi_tpu``.  Module paths mirror the reference so that each
counterpart is easy to find:

- ``device``                — default-device resolution (``cuda``, or
  raise; the CPU only when a caller asks for it).
- ``ops.layers``, ``ops.attention`` — the layers of the LM and of
  AlexNet (NHWC activations, cuDNN/cuBLAS through torch).
- ``ops.paged_attention``   — paged decode attention: a hand-written
  CUDA kernel (``csrc/paged_decode_attention.cu``) and its plain
  PyTorch version.
- ``ops.flash``             — flash attention (forward with the row
  log-sum-exp, FA-2 backward as dQ and dK/dV): hand-written CUDA
  kernels (``csrc/flash_attention.cu``) behind an
  ``autograd.Function``, and their plain versions.
- ``ops.lrn``, ``ops.pool`` — LRN forward/backward and the max-pool
  backward: hand-written CUDA kernels (``csrc/lrn.cu``,
  ``csrc/maxpool_bwd.cu``) behind ``autograd.Function``s, and their
  plain versions.
- ``ops.losses``, ``ops.optim``, ``ops.augment`` — cross-entropy and
  error rates, SGD and lr schedules, host crop/mirror.
- ``models.transformer``    — ``TransformerLM`` (dense stack; a
  ``TpuModel`` that BSP trains and the serving engines take).
- ``models.base``, ``models.alex_net`` — the model contract
  (``TpuModel``) and ``AlexNet``.
- ``data``                  — ``ImageNetData``, ``LMTextData`` and the
  prefetching loader.
- ``data.shards``           — raw shard files and the native ring
  loader (``native/shard_loader.cpp``, built with ``g++`` at first use).
- ``runtime``               — config, the ``torch.distributed`` group
  (NCCL on the card, gloo on the CPU and for ranks that share a card),
  the recorder (JSONL, TensorBoard mirror), ``fault`` (restart,
  fault injection, the stall watchdog), ``multiprocess``
  (``spawn_local``).
- ``parallel``              — bucketing, ``BSP_Exchanger`` (fp32, cast
  and block-quantized wires, error feedback), ``BSP_Worker``
  (checkpoints, resume, watchdog) and the ``BSP`` rule.
- ``utils.checkpoint``      — checkpoint files in the reference's format
  (v2), async writes, ``latest``/``prune``.
- ``launch``                — ``python -m theanompi_tpu_torch.launch``:
  presets, ``--spawn-procs``, ``--restarts``, ``--resume``.
- ``parallel.quantize``     — block quantization of the wire (int8
  round-to-nearest, int8 stochastic rounding, fp16 with a block scale,
  dequantize): hand-written CUDA kernels (``csrc/block_quant.cu``) and
  their plain versions.
- ``presets``, ``utils.benchmark`` — ``alexnet-bsp``; step time and
  images/s.
- ``convert``               — JAX parameter pytrees ↔ this port's state.
- ``serving``               — KV-cache engines and the continuous-
  batching scheduler (greedy picks).

Training, as in the reference's quick start::

    from theanompi_tpu_torch import BSP
    rule = BSP()
    rule.init(devices=1, modelfile="theanompi_tpu_torch.models.alex_net",
              modelclass="AlexNet",
              model_config=dict(compute_dtype="bfloat16",
                                lrn_impl="pallas", pool_grad="pallas"))
    rule.wait()

or from the shell::

    python -m theanompi_tpu_torch.launch --preset alexnet-bsp --devices 1

Every entry point runs on the card unless it is given ``device="cpu"``
(``--device cpu``).
"""

__version__ = "0.5.0"

__all__ = ["BSP", "__version__"]


def __getattr__(name):
    # lazy, so that importing a submodule does not load the training
    # machinery
    if name == "BSP":
        from theanompi_tpu_torch.parallel import rules

        return rules.BSP
    raise AttributeError(name)


def __dir__():
    return sorted(set(globals()) | set(__all__))

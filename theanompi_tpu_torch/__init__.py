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
- ``ops.lrn``, ``ops.pool`` — LRN forward/backward and the max-pool
  backward: hand-written CUDA kernels (``csrc/lrn.cu``,
  ``csrc/maxpool_bwd.cu``) behind ``autograd.Function``s, and their
  plain versions.
- ``ops.losses``, ``ops.optim``, ``ops.augment`` — cross-entropy and
  error rates, SGD and lr schedules, host crop/mirror.
- ``models.transformer``    — ``TransformerLM`` (dense stack).
- ``models.base``, ``models.alex_net`` — the model contract
  (``TpuModel``) and ``AlexNet``.
- ``data``                  — ``ImageNetData`` and the prefetching loader.
- ``runtime``               — config, the ``torch.distributed`` group
  (NCCL on the card, gloo on the CPU), the recorder.
- ``parallel``              — bucketing, ``BSP_Exchanger``,
  ``BSP_Worker`` and the ``BSP`` rule.
- ``presets``, ``utils.benchmark`` — ``alexnet-bsp``; step time and
  images/s.
- ``convert``               — JAX parameter pytrees → this port's state.
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

Every entry point runs on the card unless it is given ``device="cpu"``.
"""

__version__ = "0.2.0"

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

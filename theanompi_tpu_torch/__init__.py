"""theanompi_tpu_torch — the PyTorch/CUDA port of ``theanompi_tpu``.

The JAX package beside this one is the reference; this package grows
slice by slice until it does what the reference does, on an NVIDIA
Hopper card.  It imports ``torch`` and ``numpy`` and never ``jax`` or
``theanompi_tpu``.  Module paths mirror the reference so that each
counterpart is easy to find:

- ``device``                — default-device resolution (``cuda``, or
  raise; the CPU only when a caller asks for it).
- ``ops.layers``, ``ops.attention`` — the dense layers of the LM.
- ``ops.paged_attention``   — paged decode attention: a hand-written
  CUDA kernel (``csrc/paged_decode_attention.cu``) and its plain
  PyTorch version.
- ``models.transformer``    — ``TransformerLM`` (dense stack).
- ``convert``               — JAX parameter pytrees → this port's state.
- ``serving``               — KV-cache engines and the continuous-
  batching scheduler (greedy picks).

Every entry point runs on the card unless it is given ``device="cpu"``.
"""

__version__ = "0.1.0"

"""Reference parameters → this port's state.

The reference ``TransformerLM`` keeps its weights as the ``Sequential``
params list::

    [emb{table}, pos{pos},
     block{ln1{scale,bias}, attn{wq,wk,wv,wo}, ln2{scale,bias},
           mlp_in{w,b}, mlp_out{w,b}} × n_layers,
     lnf{scale,bias}, head{w,b}]

and the port's module tree mirrors it (``models.transformer``), so
``params[i]["attn"]["wq"]`` becomes ``state["net.{i}.attn.wq"]``.

Layout: every weight keeps the reference's layout.  Dense and
projection weights stay ``(in, out)`` and are applied as ``x @ w`` —
nothing is transposed — so a converted tensor equals its source
element for element.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch


def _flatten(prefix: str, tree, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            _flatten(f"{prefix}.{key}", tree[key], out)
        return
    arr = np.asarray(tree)
    if arr.dtype.kind != "f":
        raise TypeError(f"{prefix}: expected a float array, got {arr.dtype}")
    out[prefix] = torch.from_numpy(np.array(arr, dtype=np.float32))


def params_from_jax(params: Sequence[Mapping]) -> Dict[str, torch.Tensor]:
    """The reference params list (numpy leaves, one dict per layer) →
    a ``state_dict`` for ``TransformerLM`` (fp32 CPU tensors; load it
    with ``model.load_state_dict(state)``, which copies to the model's
    device)."""
    out: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(params):
        _flatten(f"net.{i}", layer, out)
    return out

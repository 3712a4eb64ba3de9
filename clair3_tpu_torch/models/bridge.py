"""Weight bridge between the JAX package's variable trees and the port's
``state_dict``s, for both nets.

The port keeps the JAX layout wherever it can, so most leaves are copies
under the same path ("/" becomes "."):

* ``params/LSTMn/{fwd,bwd}/{wi,wh,b}`` stack into ``LSTMn.{wi,wh,b}`` with
  the forward direction in slot 0 (the layout the pileup kernel reads);
* convolution kernels ``[kh, kw, I, O]`` become torch's ``[O, I, kh, kw]``
  under ``.weight``;
* ``batch_stats/.../{mean,var}`` become the BatchNorm buffers of the same
  module; BatchNorm ``scale``/``bias`` stay as they are;
* Dense ``kernel [in, out]``/``bias`` stay as they are.

Leaves keep their dtype, so ``to_jax_variables(from_jax_variables(v))``
returns ``v`` bit for bit.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from clair3_tpu_torch.models.params_io import flatten_tree, unflatten_tree

_LSTM = re.compile(r"^(LSTM\d+)/(fwd|bwd)/(wi|wh|b)$")
_LSTM_T = re.compile(r"^(LSTM\d+)\.(wi|wh|b)$")
_STATS = ("mean", "var")


def from_jax_variables(variables: Dict) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` numpy tree -> state_dict."""
    state: Dict[str, torch.Tensor] = {}
    lstm: Dict[str, Dict[str, np.ndarray]] = {}
    for key, v in flatten_tree(variables).items():
        collection, path = key.split("/", 1)
        m = _LSTM.match(path)
        if collection == "params" and m:
            lstm.setdefault(f"{m[1]}.{m[3]}", {})[m[2]] = v
            continue
        name = path.replace("/", ".")
        if collection == "params" and name.endswith(".kernel") and v.ndim == 4:
            name = name[: -len("kernel")] + "weight"
            v = v.transpose(3, 2, 0, 1)
        elif collection not in ("params", "batch_stats"):
            raise ValueError(f"unknown variable collection in {key!r}")
        state[name] = torch.from_numpy(np.ascontiguousarray(v))
    for name, dirs in lstm.items():
        state[name] = torch.from_numpy(np.stack([dirs["fwd"], dirs["bwd"]]))
    return state


def to_jax_variables(state: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of ``from_jax_variables``: state_dict -> numpy tree."""
    flat: Dict[str, np.ndarray] = {}
    for name, t in state.items():
        v = t.detach().cpu().numpy()
        m = _LSTM_T.match(name)
        if m:
            flat[f"params/{m[1]}/fwd/{m[2]}"] = v[0]
            flat[f"params/{m[1]}/bwd/{m[2]}"] = v[1]
            continue
        path = name.replace(".", "/")
        if name.endswith(".weight") and v.ndim == 4:
            path = path[: -len("weight")] + "kernel"
            v = v.transpose(2, 3, 1, 0)
        collection = "batch_stats" if path.rsplit("/", 1)[-1] in _STATS else "params"
        flat[f"{collection}/{path}"] = np.ascontiguousarray(v)
    return unflatten_tree(flat)

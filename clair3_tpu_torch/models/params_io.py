"""Flat .npz checkpoints keyed by "/"-joined tree paths.

The same format as ``clair3_tpu/models/params_io.py`` (e.g.
``params/LSTM1/fwd/wi``), re-implemented because ``clair3_tpu.models``
imports flax.  ``save_variables`` is the JAX package's (for
``models/convert.py::main``); ``load_variables`` upcasts fp16 leaves to
f32, as ``clair3_tpu.testing.load_trained_fixture`` does for the committed
fixtures.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def flatten_tree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_variables(path: str, variables: Dict) -> None:
    np.savez(path, **flatten_tree(variables))


def load_variables(path: str, upcast: bool = True) -> Dict:
    """Variable tree of a .npz checkpoint; fp16 leaves become f32 unless
    ``upcast`` is False."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if upcast:
        flat = {k: v.astype(np.float32) if v.dtype == np.float16 else v
                for k, v in flat.items()}
    return unflatten_tree(flat)

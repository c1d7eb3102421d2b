"""Carry a train state between the JAX package and the port.

Both sides key leaves by ``jax.tree_util.keystr`` paths (``.params['embed']``,
``.opt.step``, ``.opt.m['layers']['attn']['wq']``) and keep the same
layouts (``wq`` (L, d, h, hd), ``wo`` (L, h, hd, d), ``embed`` (Vp, d)),
so the carrier is a keyed copy with no transposes.  The numpy side comes
from the reference's snapshot ``_flatten`` or from a manifest restore.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.models.api import TrainState
from repro_torch.optim.adamw import AdamWState


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")          # a copy; keeps 0-d arrays 0-d
    if a.dtype.name == "bfloat16":      # ml_dtypes on the numpy side
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def tree_from_numpy(flat: Dict[str, np.ndarray], device) -> dict:
    """{keystr path: array} -> nested dict of tensors on ``device``;
    attribute steps (``.opt``) and dict keys (``['embed']``) both become
    dict keys."""
    out: dict = {}
    for key, arr in flat.items():
        parts = tu.parse_keystr(key)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_tensor(np.asarray(arr), device)
    return out


def state_from_numpy(flat: Dict[str, np.ndarray], device) -> TrainState:
    """Keystr-keyed numpy leaves of a reference ``TrainState`` -> the
    port's ``TrainState`` on ``device``."""
    t = tree_from_numpy(flat, device)
    opt = t["opt"]
    return TrainState(params=t["params"],
                      opt=AdamWState(opt["step"], opt["m"], opt["v"]))


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """The inverse: {keystr path: numpy array} in flatten order."""
    return {k: _to_numpy(v) for k, v in tu.flatten_with_keys(state)}

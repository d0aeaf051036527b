"""Training checkpoint/resume (counterpart of
``backscrub_tpu/train/checkpoint.py``).

A compressed ``.npz`` written atomically (a temp file, then a rename;
on a mesh each rank writes the same gathered tensors, each through its
own temp file),
under the JAX package's key strings, so a checkpoint crosses between the
two packages in both directions:

- ``params/['<key>']``: each parameter;
- ``opt/[0]/.count``, ``opt/[0]/.mu/['<key>']``, ``opt/[0]/.nu/['<key>']``:
  Adam's step count and moments (optax's ``ScaleByAdamState``, the first
  state of its chain; ``Trainer.opt_state`` maps them onto
  ``torch.optim``'s ``step``, ``exp_avg`` and ``exp_avg_sq``);
- ``meta/step``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _leaf(key: str) -> str:
    return f"['{key}']"


def save_checkpoint(path: str, params: Dict[str, object], opt_state: Optional[dict] = None,
                    step: int = 0) -> None:
    """Write params (+ optional ``Trainer.opt_state``) to ``path`` (.npz)."""
    payload = {f"params/{_leaf(k)}": _host(v) for k, v in params.items()}
    if opt_state is not None:
        payload["opt/[0]/.count"] = np.asarray(opt_state["count"], np.int32)
        for m in ("mu", "nu"):
            payload.update({f"opt/[0]/.{m}/{_leaf(k)}": _host(v)
                            for k, v in opt_state[m].items()})
    payload["meta/step"] = np.asarray(step)
    # a temp file a process: on a mesh every rank writes the same whole tensors
    tmp = f"{path}.tmp{os.getpid()}"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn checkpoint


def _take(flat: Dict[str, np.ndarray], prefix: str, like: Dict[str, object]):
    out = {}
    for k, old in like.items():
        name = prefix + _leaf(k)
        if name not in flat:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = flat[name]
        if tuple(arr.shape) != tuple(old.shape):
            raise ValueError(f"{name}: shape {arr.shape} != expected {tuple(old.shape)}")
        out[k] = arr
    return out


def load_checkpoint(path: str, params_like: Dict[str, object],
                    opt_state_like: Optional[dict] = None
                    ) -> Tuple[Dict[str, np.ndarray], Optional[dict], int]:
    """Restore (params, opt_state, step) as host arrays; the templates give
    the keys and shapes (the opt state is None where the file has none or
    no template is given)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    params = _take(flat, "params/", params_like)
    opt_state = None
    if opt_state_like is not None and any(k.startswith("opt/") for k in flat):
        if "opt/[0]/.count" not in flat:
            raise KeyError("checkpoint missing leaf 'opt/[0]/.count'")
        opt_state = {"count": int(flat["opt/[0]/.count"])}
        for m in ("mu", "nu"):
            opt_state[m] = _take(flat, f"opt/[0]/.{m}/", opt_state_like[m])
    step = int(flat.get("meta/step", np.asarray(0)))
    return params, opt_state, step

"""npz checkpoints (port of the JAX train/checkpoint.py, npz backend).

One ``.npz`` file holds every parameter leaf under its '/'-joined tree path
(prefix ``p/``), optional optimizer-state leaves (``__opt__/``) and a JSON
metadata blob with the reference checkpoint keys
(train_model_official.py:489-500). Files written by either package load in
the other. The JAX package's orbax directory format is not ported: loading
one raises.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

_META_KEY = "__meta_json__"
_OPT_PREFIX = "__opt__/"


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        out[prefix.rstrip("/") + "#none"] = np.zeros(0)
    else:
        if hasattr(tree, "detach"):  # a torch tensor
            tree = tree.detach().cpu().numpy()
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> Any:
    if not flat:
        return {}
    if list(flat.keys()) == [""]:
        return flat[""]
    groups: dict[str, dict] = {}
    for k, v in flat.items():
        if k.endswith("#none") and "/" not in k:
            return None
        head, _, rest = k.partition("/")
        if head.endswith("#none") and rest == "":
            groups.setdefault(head[: -len("#none")], {})[""] = None
            continue
        groups.setdefault(head, {})[rest] = v
    if all(k.isdigit() for k in groups):
        return [_unflatten_or_none(groups[str(i)]) for i in range(len(groups))]
    return {k: _unflatten_or_none(v) for k, v in groups.items()}


def _unflatten_or_none(sub):
    if list(sub.keys()) == [""] and sub[""] is None:
        return None
    return _unflatten(sub)


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def save_checkpoint(path: str, params: Any, meta: dict) -> str:
    """Write params (numpy arrays or tensors, any nesting of dicts and
    lists) and metadata as one npz file, replacing ``path`` atomically.
    (Optimizer state waits for the training slice.)"""
    payload = {f"p/{k}": v for k, v in _flatten(params).items()}
    payload[_META_KEY] = np.frombuffer(
        json.dumps(meta, default=_json_default).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    np.savez(tmp, **payload)
    # numpy appends .npz to the temp name
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    return path


def load_checkpoint(path: str):
    """Returns (params, meta, opt_state_arrays_or_None), arrays as numpy."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint directory; the port reads only "
            "the npz format (the orbax backend is listed in ROADMAP.md as "
            "not ported)")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode())
        pflat, oflat = {}, {}
        for k in z.files:
            if k.startswith("p/"):
                pflat[k[2:]] = z[k]
            elif k.startswith(_OPT_PREFIX):
                oflat[k[len(_OPT_PREFIX):]] = z[k]
    return _unflatten(pflat), meta, (_unflatten(oflat) if oflat else None)


def reference_meta(
    *,
    x_dim: int,
    max_t: int,
    use_roi: bool,
    roi_w: int,
    roi_h: int,
    labels: list[str],
    label_to_id: dict[str, int],
    id_to_label: dict[int, str],
    seed: int,
    gru_layers: int = 2,
    **extra,
) -> dict:
    """The reference checkpoint metadata contract."""
    meta = dict(
        x_dim=x_dim,
        max_t=max_t,
        use_roi=use_roi,
        roi_w=roi_w,
        roi_h=roi_h,
        labels=list(labels),
        label_to_id={str(k): int(v) for k, v in label_to_id.items()},
        id_to_label={str(k): str(v) for k, v in id_to_label.items()},
        seed=seed,
        gru_layers=gru_layers,
    )
    meta.update(extra)
    return meta

"""JAX-layout parameter tree -> reference PyTorch ``state_dict`` (copy of
the JAX package's core/torch_export.py ``export_bigru_classifier``, which
the port does not import).

The JAX package and the port's checkpoints keep the parameters as a tree in
the JAX layout (HWIO convs, (in, out) dense weights); the reference
``state_dict`` (live_infer_official.py:198-221) holds OIHW convs and
(out, in) weights under the reference names.
"""

from __future__ import annotations

import numpy as np


def _t(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32).T)


def _conv2d_out(p: dict) -> tuple[np.ndarray, np.ndarray]:
    # HWIO -> torch OIHW
    w = np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)
    return np.ascontiguousarray(w), np.asarray(p["b"], np.float32)


def _gru_dir_out(sd: dict, prefix: str, layer: int, reverse: bool, p: dict):
    sfx = f"l{layer}" + ("_reverse" if reverse else "")
    sd[f"{prefix}.weight_ih_{sfx}"] = _t(p["wi"])
    sd[f"{prefix}.weight_hh_{sfx}"] = _t(p["wh"])
    sd[f"{prefix}.bias_ih_{sfx}"] = np.asarray(p["bi"], np.float32)
    sd[f"{prefix}.bias_hh_{sfx}"] = np.asarray(p["bh"], np.float32)


def export_bigru_classifier(params: dict) -> dict[str, np.ndarray]:
    """Official-model parameter tree -> reference BiGRUClassifier
    state_dict (numpy values)."""
    sd: dict[str, np.ndarray] = {}
    if "roi_cnn" in params:
        rc = params["roi_cnn"]
        for name, key in (("net.0", "conv0"), ("net.3", "conv1"),
                          ("net.6", "conv2")):
            w, b = _conv2d_out(rc[key])
            sd[f"roi_cnn.{name}.weight"] = w
            sd[f"roi_cnn.{name}.bias"] = b
        sd["roi_cnn.fc.weight"] = _t(rc["fc"]["w"])
        sd["roi_cnn.fc.bias"] = np.asarray(rc["fc"]["b"], np.float32)
    for li, layer in enumerate(params["gru"]):
        _gru_dir_out(sd, "gru", li, False, layer["fwd"])
        if "bwd" in layer:
            _gru_dir_out(sd, "gru", li, True, layer["bwd"])
    sd["pool.score.weight"] = _t(params["pool"]["score"]["w"])
    sd["pool.score.bias"] = np.asarray(params["pool"]["score"]["b"], np.float32)
    head = params["head"]
    sd["head.0.weight"] = np.asarray(head["ln"]["scale"], np.float32)
    sd["head.0.bias"] = np.asarray(head["ln"]["bias"], np.float32)
    sd["head.1.weight"] = _t(head["fc1"]["w"])
    sd["head.1.bias"] = np.asarray(head["fc1"]["b"], np.float32)
    sd["head.4.weight"] = _t(head["fc2"]["w"])
    sd["head.4.bias"] = np.asarray(head["fc2"]["b"], np.float32)
    return sd

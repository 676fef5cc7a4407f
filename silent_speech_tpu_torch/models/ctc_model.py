"""The BiGRU-CTC model, the open-vocabulary path (port of the JAX
models/ctc_model.py).

Reference: inactive/train_model.py:141-164 ``BiGRUCTCWithROI``: the
TinyROICNN embedding (/255, no standardization) joined to the point
features, a 3-layer BiGRU (H=192), a per-frame projection to the character
vocabulary and a log-softmax over it. The vocabulary is ``<blank>`` + a-z
(inactive/train_model.py:32-35).

The modules name their parameters as the reference ``state_dict``
(``roi_cnn.net.{0,3,6}``, ``roi_cnn.fc``, ``gru.weight_ih_l{k}[_reverse]``,
``proj``). The forward shares the official model's embedding and BiGRU
(``models.bigru.SequenceModel``), with its knobs and routes: on a CUDA
device inference runs K1 (or the serving modes' K1-bf16, K4, K5) and K2 on
weights built once; the differentiable forward runs K1 with K3 as its
backward and the plain GRU scan with inter-layer dropout, since the JAX
package has no GRU kernel backward.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..ops.nn import dense, gru_dir_init, linear_init
from .bigru import (BiGRUWeights, SequenceModel, TinyROICNN, gru_tree,
                    init_roi_cnn, roi_cnn_tree)

VOCAB = ["<blank>"] + list("abcdefghijklmnopqrstuvwxyz")
BLANK_ID = 0
CHAR2ID = {c: i for i, c in enumerate(VOCAB)}
ID2CHAR = {i: c for c, i in CHAR2ID.items()}


def normalize_label(word: str) -> str:
    """Lowercase and keep a-z only (inactive/train_model.py:42-43)."""
    return "".join(ch for ch in word.lower() if "a" <= ch <= "z")


def encode_text(text: str) -> list[int]:
    return [CHAR2ID[ch] for ch in text]


@dataclasses.dataclass(frozen=True)
class CTCConfig:
    """Architecture of the CTC model (inactive/train_model.py:141-164;
    the JAX package's ``CTCTrainConfig`` widths). ``use_roi`` is always
    True: the reference model has no features-only form."""

    x_dim: int = 180
    hidden: int = 192
    gru_layers: int = 3
    roi_emb: int = 32
    num_classes: int = len(VOCAB)
    gru_dropout: float = 0.1
    roi_h: int = 48
    roi_w: int = 96
    use_roi: bool = dataclasses.field(default=True, init=False)

    @classmethod
    def from_params(cls, params: dict, **kw) -> "CTCConfig":
        """The widths a parameter tree holds (x_dim, hidden, gru_layers,
        roi_emb, num_classes), as the JAX loader reads them; ``kw`` sets
        the rest (roi_h, roi_w, gru_dropout)."""
        emb = int(np.shape(params["roi_cnn"]["fc"]["w"])[1])
        return cls(x_dim=int(np.shape(params["gru"][0]["fwd"]["wi"])[0]) - emb,
                   hidden=int(np.shape(params["gru"][0]["fwd"]["wh"])[0]),
                   gru_layers=len(params["gru"]), roi_emb=emb,
                   num_classes=int(np.shape(params["proj"]["w"])[1]), **kw)


def init_params(x_dim: int, generator: torch.Generator, *,
                hidden: int = 192, gru_layers: int = 3, roi_emb: int = 32,
                num_classes: int = len(VOCAB)) -> dict:
    """Random parameters in the JAX package's pytree layout (CPU tensors),
    PyTorch-default init drawn from ``generator``; load them with
    :meth:`BiGRUCTC.from_jax_params`."""
    layers = []
    d = x_dim + roi_emb
    for _ in range(gru_layers):
        layers.append({"fwd": gru_dir_init(d, hidden, generator),
                       "bwd": gru_dir_init(d, hidden, generator)})
        d = 2 * hidden
    return {"roi_cnn": init_roi_cnn(roi_emb, generator), "gru": layers,
            "proj": linear_init(2 * hidden, num_classes, generator)}


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def state_dict_of(params: dict) -> dict[str, torch.Tensor]:
    """A JAX-layout CTC parameter tree (numpy arrays or tensors) as the
    reference ``BiGRUCTCWithROI`` state_dict (OIHW convs, (out, in)
    weights): the inverse of the JAX package's
    ``core.torch_import.import_bigru_ctc``."""
    sd = {}
    rc = params["roi_cnn"]
    for name, key in (("net.0", "conv0"), ("net.3", "conv1"),
                      ("net.6", "conv2")):
        sd[f"roi_cnn.{name}.weight"] = _tensor(rc[key]["w"]).permute(
            3, 2, 0, 1).contiguous()
        sd[f"roi_cnn.{name}.bias"] = _tensor(rc[key]["b"])
    sd["roi_cnn.fc.weight"] = _tensor(rc["fc"]["w"]).t().contiguous()
    sd["roi_cnn.fc.bias"] = _tensor(rc["fc"]["b"])
    for k, layer in enumerate(params["gru"]):
        for d, sfx in (("fwd", f"l{k}"), ("bwd", f"l{k}_reverse")):
            p = layer[d]
            sd[f"gru.weight_ih_{sfx}"] = _tensor(p["wi"]).t().contiguous()
            sd[f"gru.weight_hh_{sfx}"] = _tensor(p["wh"]).t().contiguous()
            sd[f"gru.bias_ih_{sfx}"] = _tensor(p["bi"])
            sd[f"gru.bias_hh_{sfx}"] = _tensor(p["bh"])
    sd["proj.weight"] = _tensor(params["proj"]["w"]).t().contiguous()
    sd["proj.bias"] = _tensor(params["proj"]["b"])
    return sd


class BiGRUCTC(SequenceModel):
    """The BiGRU-CTC model. Build it with :meth:`from_jax_params` or load a
    reference ``state_dict`` into ``BiGRUCTC(cfg)``: the constructor leaves
    the parameters uninitialized."""

    def __init__(self, cfg: CTCConfig):
        super().__init__()
        self.cfg = cfg
        self.roi_cnn = TinyROICNN(cfg.roi_emb)
        self.gru = BiGRUWeights(cfg.x_dim + cfg.roi_emb, cfg.hidden,
                                cfg.gru_layers)
        self.proj = nn.utils.skip_init(nn.Linear, 2 * cfg.hidden,
                                       cfg.num_classes)

    @classmethod
    def from_jax_params(cls, params: dict, cfg: Optional[CTCConfig] = None
                        ) -> "BiGRUCTC":
        """Carry a JAX-layout parameter pytree (numpy arrays, or tensors
        from :func:`init_params`) over; the widths come from the tree where
        ``cfg`` is None. Returns a CPU model in eval mode."""
        model = cls(cfg or CTCConfig.from_params(params))
        model.load_state_dict(state_dict_of(params), strict=True)
        return model.eval()

    def params_tree(self) -> dict:
        """The JAX package's parameter pytree, as views of the parameters."""
        named = dict(self.named_parameters())
        return {"roi_cnn": roi_cnn_tree(named, "roi_cnn."),
                "gru": gru_tree(named, self.cfg.gru_layers),
                "proj": {"w": named["proj.weight"].t(),
                         "b": named["proj.bias"]}}

    def forward(self, X: torch.Tensor, lengths: torch.Tensor,
                roi: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                roi_impl: str = "auto", gru_impl: str = "auto",
                roi_variant: str = "tiled3", compute_dtype: str = "float32",
                train_cnn: Optional[Callable] = None) -> torch.Tensor:
        """X: (B, T, D) f32; lengths: (B,); roi: (B, T, H, W) uint8 frames
        (normalized /255, not standardized, inside the ROI CNN). Returns
        per-frame log-probabilities (B, T, num_classes) f32, batch first.

        The knobs are the official model's (``SequenceModel.encode``):
        ``roi_impl`` / ``gru_impl`` 'auto' | 'kernel' | 'plain';
        ``roi_variant`` 'tiled3' | 'tiled3_q8' | 'im2col' and
        ``compute_dtype`` 'float32' | 'bfloat16' (the serving modes, or the
        bf16 training route for the differentiable forward); ``train``:
        inter-layer GRU dropout (``cfg.gru_dropout``) from ``generator``.
        The projection and log-softmax run in the GRU output's type and the
        log-softmax in f32."""
        out, p = self.encode(X, lengths, roi, roi_standardize=False,
                             train=train, generator=generator,
                             roi_impl=roi_impl, gru_impl=gru_impl,
                             roi_variant=roi_variant,
                             compute_dtype=compute_dtype, train_cnn=train_cnn)
        logits = dense(out, p["proj"]).to(torch.float32)
        return torch.log_softmax(logits, dim=-1)

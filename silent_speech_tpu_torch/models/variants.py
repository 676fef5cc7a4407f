"""The historical model families of the reference's ``inactive/`` scripts
(port of the JAX models/variants.py), as ``nn.Module``s.

Families (reference source):
- TemporalCNN        inactive/dataset_eval.py:5-16, live_lower_half.py:55-71
- GRUWordClassifier  inactive/live_feed.py:29-50 (2-layer BiGRU, mean pool)
- UniGRUClassifier   inactive/train_model_1130pm.py:88-98 (final hidden)
- ReducedBiGRU       inactive/train_reduced.py:129-145 (1-layer BiGRU)
- SummaryMLP         inactive/train_5_quick.py:36-50 (mean+std clip summary)

Each module names its parameters as the reference ``state_dict`` does, so a
reference checkpoint loads with :meth:`from_state_dict` (the JAX package's
core/torch_import.py mapping: ``net.0`` / ``net.2`` + ``head``, the GRU's
``weight_ih_l{k}[_reverse]`` in PyTorch's r, z, n gate order, ``head.0`` or a
bare ``head`` for the reduced model, ``net.0/3/6`` for the MLP). Each has
``init(generator, ...)``, ``from_jax_params(tree)`` and ``params_tree()``
under the JAX tree names, so npz checkpoints of either package load in the
other. The forward runs on ``params_tree()``'s views through the port's
ops, as the JAX function does on its tree.

The GRU families feed every clip at its full length T. On a CUDA tensor
without autograd they run K2 (``ops.cuda_gru.bigru_kernel``: ``gru_proj``
then ``gru_seq`` a layer) on weights packed once (:meth:`kernel_layers`);
on the CPU and under autograd the plain scan (``ops.gru.bigru``). K2
returns outputs only: the uni-GRU's final hidden state is its output at
T - 1, which is the scan's carry there. Dropout is training-only and draws
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..ops import cuda_gru
from ..ops import gru as gru_ops
from ..ops.nn import (conv1d_init, conv1d_nwc, dense, dropout, gru_dir_init,
                      layer_norm, layer_norm_init, linear_init)
from ..ops.pooling import masked_mean_pool
from .bigru import BiGRUWeights, gru_tree, kernel_gru_layers


def named_leaves(tree, prefix: str = "") -> Iterator[tuple[str, object]]:
    """(path, leaf) pairs of a parameter tree, dict keys sorted, lists in
    order (``jax.tree.leaves`` order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def _f32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lin(named: Mapping[str, torch.Tensor], prefix: str) -> dict:
    return {"w": named[f"{prefix}.weight"].t(), "b": named[f"{prefix}.bias"]}


def _linear(d_in: int, d_out: int) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, d_in, d_out)


class Variant(nn.Module):
    """What the five families share: the parameter tree's carry-over. A
    subclass has ``params_tree()`` (views of its parameters under the JAX
    tree names) and ``_shapes(tree)``, its constructor's arguments read
    from a tree."""

    @classmethod
    def from_jax_params(cls, tree) -> "Variant":
        """A CPU model in eval mode holding a JAX-layout tree (numpy arrays
        or tensors), its widths read from the tree."""
        model = cls(**cls._shapes(tree))
        model.load_params_tree(tree)
        return model.eval()

    def load_params_tree(self, tree) -> None:
        """Copy a JAX-layout tree into the parameters (through
        ``params_tree()``'s views)."""
        views = dict(named_leaves(self.params_tree()))
        given = dict(named_leaves(tree))
        if sorted(views) != sorted(given):
            raise ValueError(f"{type(self).__name__}: the tree holds "
                             f"{sorted(given)}, the model {sorted(views)}")
        with torch.no_grad():
            for path, v in views.items():
                a = _f32(given[path])
                if tuple(a.shape) != tuple(v.shape):
                    raise ValueError(f"{path}: {tuple(a.shape)} for a "
                                     f"parameter of {tuple(v.shape)}")
                v.copy_(a)

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, torch.Tensor]) -> "Variant":
        """A CPU model in eval mode holding a reference ``state_dict``, its
        widths read from the tensors' shapes."""
        model = cls(**cls._sd_shapes(sd))
        model.load_state_dict(sd, strict=True)
        return model.eval()


# ----------------------------------------------------------------------------
# TemporalCNN: two 1-D convs (k=5) + global average + linear head
# ----------------------------------------------------------------------------


class TemporalCNN(Variant):
    """inactive/dataset_eval.py:5-16: ``net.0`` and ``net.2`` are the two
    SAME convs of its Sequential, ``head`` the linear head."""

    def __init__(self, d_in: int, num_classes: int, width: int = 128,
                 kw: int = 5):
        super().__init__()
        conv = lambda c_in: nn.utils.skip_init(nn.Conv1d, c_in, width, kw,
                                               padding=kw // 2)
        self.net = nn.ModuleDict({"0": conv(d_in), "2": conv(width)})
        self.head = _linear(width, num_classes)

    @classmethod
    def init(cls, generator: torch.Generator, d_in: int, num_classes: int,
             width: int = 128) -> "TemporalCNN":
        return cls.from_jax_params({
            "conv0": conv1d_init(5, d_in, width, generator),
            "conv1": conv1d_init(5, width, width, generator),
            "head": linear_init(width, num_classes, generator)})

    @staticmethod
    def _shapes(tree) -> dict:
        kw, d_in, width = tree["conv0"]["w"].shape
        return dict(d_in=d_in, num_classes=tree["head"]["w"].shape[1],
                    width=width, kw=kw)

    @staticmethod
    def _sd_shapes(sd) -> dict:
        width, d_in, kw = sd["net.0.weight"].shape
        return dict(d_in=d_in, num_classes=sd["head.weight"].shape[0],
                    width=width, kw=kw)

    def params_tree(self) -> dict:
        conv = lambda c: {"w": c.weight.permute(2, 1, 0), "b": c.bias}
        return {"conv0": conv(self.net["0"]), "conv1": conv(self.net["2"]),
                "head": {"w": self.head.weight.t(), "b": self.head.bias}}

    def forward(self, X: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """X: (B, T, D) -> logits (B, C), the mean over all T (the
        reference's AdaptiveAvgPool1d(1) on whole clips). With ``lengths``
        the padding is zeroed after every conv and left out of the mean:
        the same function as each clip run unpadded (a SAME conv pads with
        zeros past the end either way)."""
        p = self.params_tree()
        # the sum over time in sequence (a cumulative sum's last entry):
        # zeros past a clip's end leave it bitwise, where a vectorized sum
        # regroups the terms with the length
        time_sum = lambda h: h.cumsum(dim=1)[:, -1]
        if lengths is None:
            h = torch.relu(conv1d_nwc(X, p["conv0"]))
            h = torch.relu(conv1d_nwc(h, p["conv1"]))
            return dense(time_sum(h) / X.shape[1], p["head"])
        mask = (torch.arange(X.shape[1], device=X.device)[None, :]
                < lengths.to(X.device)[:, None]).to(X.dtype)
        m3 = mask[..., None]
        h = torch.relu(conv1d_nwc(X * m3, p["conv0"])) * m3
        h = torch.relu(conv1d_nwc(h, p["conv1"])) * m3
        n = mask.sum(dim=1, keepdim=True).clamp(min=1.0)
        return dense(time_sum(h) / n, p["head"])


# ----------------------------------------------------------------------------
# the GRU families
# ----------------------------------------------------------------------------


class GRUFamily(Variant):
    """A family whose ``gru`` (a :class:`BiGRUWeights`) runs over the whole
    clip: K2 on a CUDA tensor without autograd, the plain scan otherwise."""

    bidirectional = True

    def __init__(self):
        super().__init__()
        self._kernel_key = None
        self._kernel_layers = None

    def gru_params(self) -> list:
        return gru_tree(dict(self.named_parameters()), self.gru.num_layers,
                        self.bidirectional)

    def kernel_layers(self) -> list:
        """The GRU layers as K2 reads them (``kernel_gru_layers``), built at
        the first call that needs them and kept until a parameter moves or
        changes in place."""
        key = tuple((p.device, p.data_ptr(), p._version)
                    for p in self.gru.parameters())
        if key != self._kernel_key:
            self._kernel_layers = kernel_gru_layers(self.gru_params())
            self._kernel_key = key
        return self._kernel_layers

    def run_gru(self, X: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                gru_impl: str = "auto",
                dropout_rate: float = 0.0) -> torch.Tensor:
        """The GRU's output (B, T, dirs H) over every frame of X (B, T, D).
        Differentiable (the plain scan, inter-layer dropout under
        ``train``) when ``train`` is set or autograd records a parameter;
        otherwise the inference route: K2 on a CUDA tensor
        (``gru_impl='auto'`` or 'kernel'), the plain scan on the CPU or
        with 'plain'."""
        B, T = X.shape[:2]
        lengths = torch.full((B,), T, dtype=torch.int32, device=X.device)
        if train or (torch.is_grad_enabled()
                     and any(p.requires_grad for p in self.parameters())):
            if gru_impl == "kernel":
                raise ValueError("gru_impl='kernel': the GRU kernel has no "
                                 "backward; the differentiable forward runs "
                                 "the plain scan ('auto' or 'plain')")
            return gru_ops.bigru(X, lengths, self.gru_params(),
                                 bidirectional=self.bidirectional,
                                 dropout_rate=dropout_rate, train=train,
                                 generator=generator)[0]
        layers = (self.kernel_layers() if X.is_cuda and gru_impl != "plain"
                  else self.gru_params())
        return cuda_gru.bigru_kernel(X, lengths, layers,
                                     bidirectional=self.bidirectional,
                                     impl=gru_impl)

    @staticmethod
    def _gru_sd_shapes(sd) -> dict:
        layers = sum(1 for k in sd if k.startswith("gru.weight_ih_l")
                     and not k.endswith("_reverse"))
        return dict(d_in=sd["gru.weight_ih_l0"].shape[1],
                    hidden=sd["gru.weight_hh_l0"].shape[1],
                    num_layers=layers)


class GRUWordClassifier(GRUFamily):
    """inactive/live_feed.py:29-50: a 2-layer BiGRU (h=128), the unmasked
    mean over every frame (the reference's ``out.mean(dim=1)`` on
    zero-padded windows), then ``head``: LayerNorm, Linear, ReLU, Dropout,
    Linear (``head.0/1/4``)."""

    def __init__(self, d_in: int, num_classes: int, hidden: int = 128,
                 num_layers: int = 2, head_hidden: int = 128,
                 dropout_rate: float = 0.1, head_dropout: float = 0.2):
        super().__init__()
        self.dropout_rate, self.head_dropout = dropout_rate, head_dropout
        self.gru = BiGRUWeights(d_in, hidden, num_layers)
        self.head = nn.Sequential(
            nn.utils.skip_init(nn.LayerNorm, 2 * hidden),
            _linear(2 * hidden, head_hidden), nn.ReLU(),
            nn.Dropout(head_dropout), _linear(head_hidden, num_classes))

    @classmethod
    def init(cls, generator: torch.Generator, d_in: int, num_classes: int,
             hidden: int = 128, num_layers: int = 2
             ) -> "GRUWordClassifier":
        layers, d = [], d_in
        for _ in range(num_layers):
            layers.append({"fwd": gru_dir_init(d, hidden, generator),
                           "bwd": gru_dir_init(d, hidden, generator)})
            d = 2 * hidden
        return cls.from_jax_params({"gru": layers, "head": {
            "ln": layer_norm_init(2 * hidden),
            "fc1": linear_init(2 * hidden, 128, generator),
            "fc2": linear_init(128, num_classes, generator)}})

    @staticmethod
    def _shapes(tree) -> dict:
        fc1, fc2 = tree["head"]["fc1"]["w"], tree["head"]["fc2"]["w"]
        return dict(d_in=tree["gru"][0]["fwd"]["wi"].shape[0],
                    num_classes=fc2.shape[1],
                    hidden=tree["gru"][0]["fwd"]["wh"].shape[0],
                    num_layers=len(tree["gru"]), head_hidden=fc1.shape[1])

    @classmethod
    def _sd_shapes(cls, sd) -> dict:
        return dict(cls._gru_sd_shapes(sd),
                    num_classes=sd["head.4.weight"].shape[0],
                    head_hidden=sd["head.1.weight"].shape[0])

    def params_tree(self) -> dict:
        named = dict(self.named_parameters())
        return {"gru": self.gru_params(), "head": {
            "ln": {"scale": named["head.0.weight"],
                   "bias": named["head.0.bias"]},
            "fc1": _lin(named, "head.1"), "fc2": _lin(named, "head.4")}}

    def forward(self, X: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                gru_impl: str = "auto") -> torch.Tensor:
        """X: (B, T, D) -> logits (B, C); ``train``: the GRU's inter-layer
        and the head's dropout, drawn from ``generator``."""
        out = self.run_gru(X, train=train, generator=generator,
                           gru_impl=gru_impl, dropout_rate=self.dropout_rate)
        p = self.params_tree()["head"]
        h = layer_norm(masked_mean_pool(out), p["ln"])
        h = torch.relu(dense(h, p["fc1"]))
        h = dropout(h, self.head_dropout, generator, train)
        return dense(h, p["fc2"])


class UniGRUClassifier(GRUFamily):
    """inactive/train_model_1130pm.py:88-98: a 1-layer forward GRU (h=128),
    dropout on its final hidden state, a linear ``head``."""

    bidirectional = False

    def __init__(self, d_in: int, num_classes: int, hidden: int = 128,
                 num_layers: int = 1, dropout_rate: float = 0.2):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.gru = BiGRUWeights(d_in, hidden, num_layers, bidirectional=False)
        self.head = _linear(hidden, num_classes)

    @classmethod
    def init(cls, generator: torch.Generator, d_in: int, num_classes: int,
             hidden: int = 128) -> "UniGRUClassifier":
        return cls.from_jax_params({
            "gru": [{"fwd": gru_dir_init(d_in, hidden, generator)}],
            "head": linear_init(hidden, num_classes, generator)})

    @staticmethod
    def _shapes(tree) -> dict:
        return dict(d_in=tree["gru"][0]["fwd"]["wi"].shape[0],
                    num_classes=tree["head"]["w"].shape[1],
                    hidden=tree["gru"][0]["fwd"]["wh"].shape[0],
                    num_layers=len(tree["gru"]))

    @classmethod
    def _sd_shapes(cls, sd) -> dict:
        return dict(cls._gru_sd_shapes(sd),
                    num_classes=sd["head.weight"].shape[0])

    def params_tree(self) -> dict:
        return {"gru": self.gru_params(),
                "head": _lin(dict(self.named_parameters()), "head")}

    def forward(self, X: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                gru_impl: str = "auto") -> torch.Tensor:
        """X: (B, T, D) -> logits (B, C) from the final hidden state;
        ``train``: its dropout, drawn from ``generator``."""
        h_last = self.run_gru(X, gru_impl=gru_impl)[:, -1]
        h_last = dropout(h_last, self.dropout_rate, generator, train)
        return dense(h_last, self.params_tree()["head"])


class ReducedBiGRU(GRUFamily):
    """inactive/train_reduced.py:129-145: a 1-layer BiGRU (h=64), the
    unmasked mean over every frame, one linear layer (``head.0``: the
    reference declares the head a Sequential)."""

    def __init__(self, d_in: int, num_classes: int, hidden: int = 64,
                 num_layers: int = 1):
        super().__init__()
        self.gru = BiGRUWeights(d_in, hidden, num_layers)
        self.head = nn.Sequential(_linear(2 * hidden, num_classes))

    @classmethod
    def init(cls, generator: torch.Generator, d_in: int, num_classes: int,
             hidden: int = 64) -> "ReducedBiGRU":
        return cls.from_jax_params({
            "gru": [{"fwd": gru_dir_init(d_in, hidden, generator),
                     "bwd": gru_dir_init(d_in, hidden, generator)}],
            "head": linear_init(2 * hidden, num_classes, generator)})

    @staticmethod
    def _shapes(tree) -> dict:
        return dict(d_in=tree["gru"][0]["fwd"]["wi"].shape[0],
                    num_classes=tree["head"]["w"].shape[1],
                    hidden=tree["gru"][0]["fwd"]["wh"].shape[0],
                    num_layers=len(tree["gru"]))

    @classmethod
    def _sd_shapes(cls, sd) -> dict:
        return dict(cls._gru_sd_shapes(sd),
                    num_classes=sd["head.0.weight"].shape[0])

    @classmethod
    def from_state_dict(cls, sd) -> "ReducedBiGRU":
        """As :meth:`Variant.from_state_dict`, also under the caden demos'
        bare-Linear head names (``head.*``), the naming skew that makes the
        reference's own loader fail."""
        sd = dict(sd)
        if "head.weight" in sd and "head.0.weight" not in sd:
            sd["head.0.weight"] = sd.pop("head.weight")
            sd["head.0.bias"] = sd.pop("head.bias")
        return super().from_state_dict(sd)

    def params_tree(self) -> dict:
        return {"gru": self.gru_params(),
                "head": _lin(dict(self.named_parameters()), "head.0")}

    def forward(self, X: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                gru_impl: str = "auto") -> torch.Tensor:
        """X: (B, T, D) -> logits (B, C). The family has no dropout;
        ``train`` and ``generator`` are taken for a uniform call."""
        out = self.run_gru(X, gru_impl=gru_impl)
        return dense(masked_mean_pool(out), self.params_tree()["head"])


# ----------------------------------------------------------------------------
# SummaryMLP: clip -> [mean(D), std(D)] summary -> 3-layer MLP
# ----------------------------------------------------------------------------


def clip_to_summary(X: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, D) -> (B, 2D) [per-dim mean, per-dim population std]
    (inactive/train_5_quick.py:13-17, np.std's); with ``lengths`` over the
    valid frames only."""
    if lengths is None:
        return torch.cat([X.mean(dim=1), X.std(dim=1, correction=0)], -1)
    mask = (torch.arange(X.shape[1], device=X.device)[None, :]
            < lengths.to(X.device)[:, None]).to(X.dtype)[..., None]
    n = mask.sum(dim=1).clamp(min=1.0)
    mu = (X * mask).sum(dim=1) / n
    var = ((X - mu[:, None, :]).square() * mask).sum(dim=1) / n
    return torch.cat([mu, var.sqrt()], -1)


class SummaryMLP(Variant):
    """inactive/train_5_quick.py:36-50: Linear, ReLU, Dropout, Linear, ReLU,
    Dropout, Linear (``net.0/3/6``) on the clip's summary. The trainer
    builds 128 / 64 hidden units (``init``); the reference quick-MLP
    checkpoints hold 256 / 128, read from their tensors."""

    def __init__(self, in_dim: int, num_classes: int, widths=(128, 64),
                 dropout_rate: float = 0.2):
        super().__init__()
        self.dropout_rate = dropout_rate
        w0, w1 = widths
        self.net = nn.Sequential(
            _linear(in_dim, w0), nn.ReLU(), nn.Dropout(dropout_rate),
            _linear(w0, w1), nn.ReLU(), nn.Dropout(dropout_rate),
            _linear(w1, num_classes))

    @classmethod
    def init(cls, generator: torch.Generator, in_dim: int,
             num_classes: int) -> "SummaryMLP":
        return cls.from_jax_params({
            "fc0": linear_init(in_dim, 128, generator),
            "fc1": linear_init(128, 64, generator),
            "fc2": linear_init(64, num_classes, generator)})

    @staticmethod
    def _shapes(tree) -> dict:
        return dict(in_dim=tree["fc0"]["w"].shape[0],
                    num_classes=tree["fc2"]["w"].shape[1],
                    widths=(tree["fc0"]["w"].shape[1],
                            tree["fc1"]["w"].shape[1]))

    @staticmethod
    def _sd_shapes(sd) -> dict:
        return dict(in_dim=sd["net.0.weight"].shape[1],
                    num_classes=sd["net.6.weight"].shape[0],
                    widths=(sd["net.0.weight"].shape[0],
                            sd["net.3.weight"].shape[0]))

    def params_tree(self) -> dict:
        named = dict(self.named_parameters())
        return {f"fc{i}": _lin(named, f"net.{k}")
                for i, k in enumerate((0, 3, 6))}

    def forward(self, feat: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """feat: (B, 2D) summary -> logits (B, C); ``train``: dropout after
        both hidden layers, drawn from ``generator``."""
        p = self.params_tree()
        h = dropout(torch.relu(dense(feat, p["fc0"])), self.dropout_rate,
                    generator, train)
        h = dropout(torch.relu(dense(h, p["fc1"])), self.dropout_rate,
                    generator, train)
        return dense(h, p["fc2"])

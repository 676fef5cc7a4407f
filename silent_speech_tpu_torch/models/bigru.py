"""The official model (port of the JAX models/bigru.py): TinyROICNN + 2-layer
BiGRU + attention pool + LayerNorm/MLP head, train_model_official.py:209-310.

The modules name their parameters exactly as the reference ``state_dict``
does (``roi_cnn.net.{0,3,6}``, ``roi_cnn.fc``, ``gru.weight_ih_l{k}[_reverse]``,
``pool.score``, ``head.{0,1,4}``), so a reference ``.pt`` loads with
``load_state_dict``. The forward runs on the JAX-layout parameter tree
(``params_tree()``: views, no copies) through the port's ops, so each step
has a JAX counterpart the tests hold it against. On a CUDA device inference
runs the kernels on weights built once in their own layouts
(``kernel_weights()``); the differentiable forward (training) runs the ROI
CNN's forward and weight-gradient kernels on a flat weight buffer built
from the parameters each call, and the plain GRU scan.

Inference serves the JAX Predictor's modes. ``roi_variant`` picks the ROI
CNN: 'tiled3' (``cuda_cnn``, K1), 'tiled3_q8' (``cuda_cnn_q8``, int8) or
'im2col' (``cuda_cnn_im2col``, the counterpart of the JAX
``roi_impl='pallas'``). ``compute_dtype='bfloat16'`` is the JAX package's
bf16 serving mode with its GRU kernel (``gru_impl='pallas'``): X and the
ROI embedding rounded to bf16 (models/bigru.py:249,351 there), the 'tiled3'
CNN in its bf16 build, the GRU and the head in f32 on the rounded values.
The JAX package's bf16 *scan* (``gru_impl='scan'``) is another function,
with bf16 matmuls in the recurrence, and the port does not serve it; it is
the bf16 *training* route (``train_forward(compute_dtype='bfloat16')``:
the ROI CNN kernels in f32, the embedding cast to bf16, the scan and head
in bf16, as the JAX train step's, train/step.py:103 there).

``SequenceModel`` holds what the official model and the CTC model
(models/ctc_model.py) share: the ROI embedding joined to the features, the
BiGRU, every route above, and the kernels' weight layouts.

The reference's dual forward is kept: ``forward(..., roi_standardize=True)``
is the training-path normalization (/255 then per-frame standardize), and
``live_forward`` the live-inference path (/255 only). The same weights give
different logits on the two.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..core.torch_export import export_bigru_classifier
from ..ops import cuda_cnn, cuda_cnn_im2col, cuda_cnn_q8, cuda_gru
from ..ops import gru as gru_ops
from ..ops.cuda_cnn import preprocess_roi, standardize_frames  # noqa: F401
from ..ops.nn import (conv_init, dense, dropout, gru_dir_init, layer_norm,
                      layer_norm_init, linear_init)
from ..ops.pooling import attn_pool


ROI_VARIANTS = ("tiled3", "tiled3_q8", "im2col")
COMPUTE_DTYPES = ("float32", "bfloat16")
# the weight layout of each ROI CNN kernel (BiGRUClassifier.kernel_weights),
# under the kernel's name
ROI_PACKS = {"roi_cnn": cuda_cnn.flat_weights,
             "roi_cnn_bf16": cuda_cnn.flat_weights_bf16,
             "roi_cnn_q8": cuda_cnn_q8.quantize_roi_cnn,
             "roi_cnn_im2col": cuda_cnn_im2col.pack_im2col}


def roi_pack_name(roi_variant: str, compute_dtype: str) -> str:
    """The ROI CNN kernel (and ROI_PACKS entry) a serving mode runs."""
    if roi_variant == "tiled3":
        return "roi_cnn_bf16" if compute_dtype == "bfloat16" else "roi_cnn"
    return {"tiled3_q8": "roi_cnn_q8", "im2col": "roi_cnn_im2col"}[
        roi_variant]


@dataclasses.dataclass(frozen=True)
class BiGRUConfig:
    """Architecture hyperparameters (reference defaults,
    train_model_official.py:254,402)."""

    x_dim: int = 180
    num_classes: int = 10
    use_roi: bool = True
    roi_emb: int = 32
    hidden: int = 192
    gru_layers: int = 2
    gru_dropout: float = 0.1
    head_dropout: float = 0.2
    head_hidden: int = 128
    roi_h: int = 48
    roi_w: int = 96


def init_roi_cnn(out_dim: int, generator: torch.Generator) -> dict:
    return {"conv0": conv_init(3, 3, 1, 8, generator),
            "conv1": conv_init(3, 3, 8, 16, generator),
            "conv2": conv_init(3, 3, 16, 24, generator),
            "fc": linear_init(24, out_dim, generator)}


def init_params(cfg: BiGRUConfig, generator: torch.Generator) -> dict:
    """Random parameters in the JAX package's pytree layout (CPU tensors),
    PyTorch-default init drawn from ``generator``; load them with
    ``BiGRUClassifier.from_jax_params``."""
    H = cfg.hidden
    layers = []
    d = cfg.x_dim + (cfg.roi_emb if cfg.use_roi else 0)
    for _ in range(cfg.gru_layers):
        layers.append({"fwd": gru_dir_init(d, H, generator),
                       "bwd": gru_dir_init(d, H, generator)})
        d = 2 * H
    params = {
        "gru": layers,
        "pool": {"score": linear_init(2 * H, 1, generator)},
        "head": {"ln": layer_norm_init(2 * H),
                 "fc1": linear_init(2 * H, cfg.head_hidden, generator),
                 "fc2": linear_init(cfg.head_hidden, cfg.num_classes,
                                    generator)},
    }
    if cfg.use_roi:
        params["roi_cnn"] = init_roi_cnn(cfg.roi_emb, generator)
    return params


def roi_embedding(p_roi: dict, roi: torch.Tensor, *, standardize: bool,
                  roi_impl: str = "auto", roi_pack: str = "roi_cnn",
                  packed=None, differentiable: bool = False,
                  train_cnn: Optional[Callable] = None) -> torch.Tensor:
    """TinyROICNN embedding: (B, T, H, W) uint8 -> (B, T, emb) f32, through
    the ROI CNN kernel ``roi_pack`` (a ROI_PACKS name, ``roi_pack_name`` of
    the serving mode) or its plain version (``roi_impl``). ``packed``: the
    kernel's weights in its layout (``ROI_PACKS[roi_pack](p_roi)``), for
    inference. ``differentiable``: the training CNN
    (``cuda_cnn.roi_cnn_fused_train``, the f32 'roi_cnn' only), whose
    gradient reaches ``p_roi``, or ``train_cnn(frames, p_roi,
    standardize)`` in its place where given."""
    if roi.dtype != torch.uint8:
        raise ValueError(f"the ROI embedding takes raw uint8 frames, got "
                         f"{roi.dtype}")
    B, T = roi.shape[:2]
    frames = roi.reshape(B * T, *roi.shape[2:])
    if differentiable and train_cnn is not None:
        emb = train_cnn(frames, p_roi, standardize)
    elif differentiable:
        emb = cuda_cnn.roi_cnn_fused_train(frames, p_roi,
                                           standardize=standardize,
                                           impl=roi_impl)
    elif roi_pack == "roi_cnn":
        emb = cuda_cnn.roi_cnn_fused(frames, p_roi, standardize=standardize,
                                     impl=roi_impl, flat=packed)
    elif roi_pack == "roi_cnn_bf16":
        emb = cuda_cnn.roi_cnn_bf16(frames, p_roi, standardize=standardize,
                                    impl=roi_impl, flat=packed)
    elif roi_pack == "roi_cnn_q8":
        emb = cuda_cnn_q8.roi_cnn_q8(frames, p_roi, standardize=standardize,
                                     impl=roi_impl, packed=packed)
    else:
        emb = cuda_cnn_im2col.roi_cnn_im2col(frames, p_roi,
                                             standardize=standardize,
                                             impl=roi_impl, packed=packed)
    return emb.reshape(B, T, -1)


def roi_cnn_tree(named: Mapping[str, torch.Tensor], prefix: str) -> dict:
    """The TinyROICNN part of :func:`jax_tree` (HWIO convs, (in, out) fc),
    from tensors named ``prefix + 'net.{0,3,6}.weight'`` ..."""
    tree = {f"conv{i}": {"w": named[f"{prefix}net.{k}.weight"].permute(
        2, 3, 1, 0), "b": named[f"{prefix}net.{k}.bias"]}
        for i, k in enumerate(("0", "3", "6"))}
    tree["fc"] = {"w": named[f"{prefix}fc.weight"].t(),
                  "b": named[f"{prefix}fc.bias"]}
    return tree


def gru_tree(named: Mapping[str, torch.Tensor], gru_layers: int,
             bidirectional: bool = True) -> list:
    """The GRU part of :func:`jax_tree` ((D, 3H) / (H, 3H) views), from
    tensors named ``gru.weight_ih_l{k}[_reverse]`` ...: a layer's 'fwd'
    and, when bidirectional, its 'bwd' direction."""
    def direction(sfx):
        return {"wi": named[f"gru.weight_ih_{sfx}"].t(),
                "wh": named[f"gru.weight_hh_{sfx}"].t(),
                "bi": named[f"gru.bias_ih_{sfx}"],
                "bh": named[f"gru.bias_hh_{sfx}"]}

    return [{"fwd": direction(f"l{k}"), "bwd": direction(f"l{k}_reverse")}
            if bidirectional else {"fwd": direction(f"l{k}")}
            for k in range(gru_layers)]


def kernel_gru_layers(layers: list) -> list:
    """GRU layers ({'fwd': ..., 'bwd': ...} or {'fwd': ...}) as K2 reads
    them: contiguous (D, 3H) / (H, 3H) matrices and each layer's
    ``'packed'`` layout for the two kernels (``cuda_gru.pack_layer``)."""
    with torch.no_grad():
        out = [{d: {k: v.contiguous() for k, v in lp[d].items()}
                for d in lp} for lp in layers]
        for lp in out:
            lp["packed"] = cuda_gru.pack_layer(
                [(lp["fwd"], False)]
                + ([(lp["bwd"], True)] if "bwd" in lp else []))
    return out


def jax_tree(named: Mapping[str, torch.Tensor], cfg: BiGRUConfig) -> dict:
    """The JAX package's parameter tree built from tensors under the
    reference ``state_dict`` names, as views (HWIO convs, (in, out) dense
    weights): the model's parameters, or any per-parameter state such as
    Adam's moments."""
    lin = lambda pfx: {"w": named[pfx + ".weight"].t(),
                       "b": named[pfx + ".bias"]}
    tree = {
        "gru": gru_tree(named, cfg.gru_layers),
        "pool": {"score": lin("pool.score")},
        "head": {"ln": {"scale": named["head.0.weight"],
                        "bias": named["head.0.bias"]},
                 "fc1": lin("head.1"), "fc2": lin("head.4")},
    }
    if cfg.use_roi:
        tree["roi_cnn"] = roi_cnn_tree(named, "roi_cnn.")
    return tree


def tree_leaves(tree) -> list:
    """The leaves of a parameter tree in ``jax.tree.leaves`` order: dict
    keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


class TinyROICNN(nn.Module):
    """The reference TinyROICNN's parameters (train_model_official.py:
    209-229) under its names: ``net.{0,3,6}`` are the three 3x3 convs of
    its Sequential (ReLU and pooling hold no parameters), ``fc`` the
    projection. :func:`roi_embedding` runs it on ``params_tree()``."""

    def __init__(self, out_dim: int = 32):
        super().__init__()
        conv = lambda c_in, c_out: nn.utils.skip_init(
            nn.Conv2d, c_in, c_out, 3, padding=1)
        self.net = nn.ModuleDict({"0": conv(1, 8), "3": conv(8, 16),
                                  "6": conv(16, 24)})
        self.fc = nn.utils.skip_init(nn.Linear, 24, out_dim)

    def params_tree(self) -> dict:
        """JAX layout (HWIO convs, (in, out) fc) as views of the parameters."""
        return roi_cnn_tree(dict(self.named_parameters()), "")


class BiGRUWeights(nn.Module):
    """The parameters of a bidirectional (or, with ``bidirectional=False``,
    a forward) ``nn.GRU`` under its names (``weight_ih_l{k}[_reverse]``
    ...); the scan runs in ops.gru and ops.cuda_gru on :func:`jax_tree`'s
    views of them."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int,
                 bidirectional: bool = True):
        super().__init__()
        self.num_layers = num_layers
        d = in_dim
        for k in range(num_layers):
            for sfx in (f"l{k}", f"l{k}_reverse")[:1 + bidirectional]:
                for name, shape in ((f"weight_ih_{sfx}", (3 * hidden, d)),
                                    (f"weight_hh_{sfx}", (3 * hidden, hidden)),
                                    (f"bias_ih_{sfx}", (3 * hidden,)),
                                    (f"bias_hh_{sfx}", (3 * hidden,))):
                    self.register_parameter(
                        name, nn.Parameter(torch.empty(shape)))
            d = (1 + bidirectional) * hidden


class AttnPool(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.score = nn.utils.skip_init(nn.Linear, dim, 1)


class SequenceModel(nn.Module):
    """What the official classifier and the CTC model (models/ctc_model.py)
    share: the ROI embedding joined to the features and the BiGRU over
    them, in every mode, on the kernels' weight layouts kept by
    :meth:`kernel_weights`. A subclass has ``cfg`` (``x_dim``, ``use_roi``,
    ``roi_emb``, ``hidden``, ``gru_layers``, ``gru_dropout``), ``roi_cnn``,
    ``gru`` and :meth:`params_tree`; its head reads :meth:`encode`'s
    output."""

    def __init__(self):
        super().__init__()
        self._kernel_weights_key = None
        self._kernel_weights = None

    def kernel_weights(self, roi_pack: str = "roi_cnn") -> dict:
        """The kernels' weight layouts on the parameters' device: ``'gru'``,
        the layers' (D, 3H) / (H, 3H) matrices made contiguous, with each
        layer's ``'packed'`` layout for the two GRU kernels
        (``cuda_gru.pack_layer``), and the ROI
        CNN kernel ``roi_pack``'s (ROI_PACKS), under its name, with those of
        the other ROI CNN kernels asked for before. Built at the first call
        that needs them and kept until a parameter moves or changes in
        place."""
        key = tuple((p.device, p.data_ptr(), p._version)
                    for p in self.parameters())
        if key != self._kernel_weights_key:
            self._kernel_weights = {
                "gru": kernel_gru_layers(self.params_tree()["gru"])}
            self._kernel_weights_key = key
        kw = self._kernel_weights
        if roi_pack not in kw:
            with torch.no_grad():
                kw[roi_pack] = (ROI_PACKS[roi_pack](self.params_tree()[
                    "roi_cnn"]) if self.cfg.use_roi else None)
        return kw

    def encode(self, X: torch.Tensor, lengths: torch.Tensor,
               roi: Optional[torch.Tensor], *, roi_standardize: bool,
               train: bool = False,
               generator: Optional[torch.Generator] = None,
               roi_impl: str = "auto", gru_impl: str = "auto",
               roi_variant: str = "tiled3", compute_dtype: str = "float32",
               train_cnn: Optional[Callable] = None,
               differentiable: Optional[bool] = None
               ) -> tuple[torch.Tensor, dict]:
        """The BiGRU's output (B, T, 2H) over the features joined to the ROI
        embedding, and the parameter tree (``params_tree()``).

        The forward is differentiable when ``differentiable`` says so, or,
        where it is None, when ``train`` is set or autograd records it (grad
        mode on and a parameter requires grad). The differentiable forward
        runs ``roi_cnn_fused_train`` (or ``train_cnn``) and the plain GRU
        scan, with inter-layer dropout drawn from ``generator`` under
        ``train``; with ``compute_dtype='bfloat16'`` it is the JAX
        package's bf16 training route (train/step.py:103 there): the ROI CNN
        in f32 and its embedding cast to bf16 (models/bigru.py:229-235),
        X, the scan and the output in bf16. Otherwise it is the inference
        forward on ``kernel_weights()``, in the serving mode ``roi_variant``
        / ``compute_dtype`` (module docstring), output f32."""
        if train and generator is None:
            raise ValueError("generator is required for the training "
                             "forward (dropout)")
        if differentiable is None:
            differentiable = train or (torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()))
        if differentiable and gru_impl == "kernel":
            raise ValueError("gru_impl='kernel': the GRU kernel has no "
                             "backward; the differentiable forward runs "
                             "the plain scan ('auto' or 'plain')")
        if compute_dtype not in COMPUTE_DTYPES or \
                roi_variant not in ROI_VARIANTS:
            raise ValueError(f"roi_variant={roi_variant!r}, compute_dtype="
                             f"{compute_dtype!r}: the port serves "
                             f"roi_variant in {ROI_VARIANTS}, compute_dtype "
                             f"in {COMPUTE_DTYPES}")
        if differentiable and roi_variant != "tiled3":
            raise ValueError(
                f"roi_variant={roi_variant!r} is a serving-only mode: the "
                "differentiable forward takes 'tiled3'")
        if roi is not None and roi.is_cuda and roi_impl != "plain" and \
                tuple(roi.shape[2:]) != (cuda_cnn.ROI_H, cuda_cnn.ROI_W):
            raise ValueError(
                f"roi_impl={roi_impl!r}: the ROI CNN kernels take "
                f"{cuda_cnn.ROI_H}x{cuda_cnn.ROI_W} frames, got "
                f"{tuple(roi.shape[2:])}; pass roi_impl='plain' for this ROI")
        bf16 = compute_dtype == "bfloat16"
        pack = "roi_cnn" if differentiable else roi_pack_name(roi_variant,
                                                              compute_dtype)
        dtype = torch.bfloat16 if bf16 and differentiable else torch.float32
        p = self.params_tree()
        X = X.to(dtype)
        if bf16 and not differentiable:
            X = cuda_cnn.round_bf16(X)
        lengths = lengths.to(X.device)
        kw = self.kernel_weights(pack) if X.is_cuda and not differentiable \
            else {"gru": p["gru"]}
        if self.cfg.use_roi:
            if roi is None:
                raise ValueError("model was built with use_roi=True but got "
                                 "roi=None")
            roi_e = roi_embedding(p["roi_cnn"], roi, standardize=roi_standardize,
                                  roi_impl=roi_impl, roi_pack=pack,
                                  packed=kw.get(pack),
                                  differentiable=differentiable,
                                  train_cnn=train_cnn)
            roi_e = roi_e.to(dtype) if differentiable else (
                cuda_cnn.round_bf16(roi_e) if bf16 else roi_e)
            Z = torch.cat([X, roi_e], dim=-1)
        else:
            Z = X
        if differentiable:
            rate = self.cfg.gru_dropout if self.cfg.gru_layers > 1 else 0.0
            out = gru_ops.bigru(Z, lengths, p["gru"], dropout_rate=rate,
                                train=train, generator=generator)[0]
        else:
            out = cuda_gru.bigru_kernel(Z, lengths, kw["gru"], impl=gru_impl)
        return out, p


class BiGRUClassifier(SequenceModel):
    """The official BiGRU classifier. Build it with :meth:`from_jax_params`
    or load a reference ``state_dict`` into ``BiGRUClassifier(cfg)``: the
    constructor leaves the parameters uninitialized."""

    def __init__(self, cfg: BiGRUConfig):
        super().__init__()
        self.cfg = cfg
        H2 = 2 * cfg.hidden
        if cfg.use_roi:
            self.roi_cnn = TinyROICNN(cfg.roi_emb)
        self.gru = BiGRUWeights(
            cfg.x_dim + (cfg.roi_emb if cfg.use_roi else 0), cfg.hidden,
            cfg.gru_layers)
        self.pool = AttnPool(H2)
        self.head = nn.Sequential(
            nn.utils.skip_init(nn.LayerNorm, H2),
            nn.utils.skip_init(nn.Linear, H2, cfg.head_hidden), nn.ReLU(),
            nn.Dropout(cfg.head_dropout),
            nn.utils.skip_init(nn.Linear, cfg.head_hidden, cfg.num_classes),
        )

    @classmethod
    def from_jax_params(cls, params: dict, cfg: BiGRUConfig
                        ) -> "BiGRUClassifier":
        """Carry a JAX-layout parameter pytree (numpy arrays, or CPU tensors
        from :func:`init_params`) over through the reference ``state_dict``
        layout (core.torch_export). Returns a CPU model in eval mode."""
        sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
              for k, v in export_bigru_classifier(params).items()}
        model = cls(cfg)
        model.load_state_dict(sd, strict=True)
        return model.eval()

    def params_tree(self) -> dict:
        """The JAX package's parameter pytree, as views of the parameters."""
        return jax_tree(dict(self.named_parameters()), self.cfg)

    def forward(self, X: torch.Tensor, lengths: torch.Tensor,
                roi: Optional[torch.Tensor] = None, *,
                roi_standardize: bool = True, train: bool = False,
                generator: Optional[torch.Generator] = None,
                roi_impl: str = "auto", gru_impl: str = "auto",
                roi_variant: str = "tiled3", compute_dtype: str = "float32",
                train_cnn: Optional[Callable] = None,
                differentiable: Optional[bool] = None) -> torch.Tensor:
        """X: (B, T, D) f32; lengths: (B,); roi: (B, T, H, W) uint8 or None.
        Returns logits (B, num_classes) f32. ``roi_impl`` / ``gru_impl``:
        'auto' | 'kernel' | 'plain' (ops._kernels). ``roi_variant`` and
        ``compute_dtype``: the serving modes (module docstring), or with
        the differentiable forward the training route in f32 or bf16
        (:meth:`SequenceModel.encode`). ``train_cnn``: the differentiable
        forward's ROI CNN, (frames, params, standardize) -> embeddings, in
        place of ``roi_cnn_fused_train`` (a check's reference).

        ``train``: GRU inter-layer and head dropout, drawn from
        ``generator`` (on X's device). The differentiable forward runs the
        plain GRU scan, since the GRU kernel has no backward
        (``gru_impl='kernel'`` raises there); the inference forward the
        kernels on ``kernel_weights()``. The head runs in the GRU output's
        type."""
        out, p = self.encode(X, lengths, roi, roi_standardize=roi_standardize,
                             train=train, generator=generator,
                             roi_impl=roi_impl, gru_impl=gru_impl,
                             roi_variant=roi_variant,
                             compute_dtype=compute_dtype, train_cnn=train_cnn,
                             differentiable=differentiable)
        pooled = attn_pool(out, lengths.to(out.device), p["pool"])
        h = layer_norm(pooled, p["head"]["ln"])
        h = torch.relu(dense(h, p["head"]["fc1"]))
        h = dropout(h, self.cfg.head_dropout, generator, train)
        return dense(h, p["head"]["fc2"]).to(torch.float32)

    def live_forward(self, X, lengths, roi=None, *, roi_impl: str = "auto",
                     gru_impl: str = "auto", roi_variant: str = "tiled3",
                     compute_dtype: str = "float32") -> torch.Tensor:
        """The live-inference forward (no ROI standardization, no dropout):
        the parity target against live_infer_official.py:124-138, in any
        serving mode."""
        return self.forward(X, lengths, roi, roi_standardize=False,
                            roi_impl=roi_impl, gru_impl=gru_impl,
                            roi_variant=roi_variant,
                            compute_dtype=compute_dtype)

    def train_forward(self, X, lengths, roi=None, *, train: bool = True,
                      generator: Optional[torch.Generator] = None,
                      roi_impl: str = "auto", gru_impl: str = "auto",
                      compute_dtype: str = "float32",
                      train_cnn: Optional[Callable] = None) -> torch.Tensor:
        """The training-path forward (per-frame ROI standardization,
        train_model_official.py:279-310); ``train`` adds dropout drawn from
        ``generator``; ``train_cnn`` as in :meth:`forward`.
        ``compute_dtype='bfloat16'`` is the bf16 training route with or
        without autograd (the JAX package validates on it too), which has
        no inference form: its GRU scan runs in bf16, where the GRU kernel
        runs in f32."""
        return self.forward(X, lengths, roi, roi_standardize=True,
                            train=train, generator=generator,
                            roi_impl=roi_impl, gru_impl=gru_impl,
                            compute_dtype=compute_dtype, train_cnn=train_cnn,
                            differentiable=(True if compute_dtype ==
                                            "bfloat16" else None))

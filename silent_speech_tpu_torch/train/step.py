"""Train and eval steps of the official classifier (port of the JAX
train/step.py).

One train step is the reference inner loop (train_model_official.py:
426-443): augment, the training forward with dropout, cross entropy with
label smoothing, backward, a global-norm clip of the gradients, an Adam
step. On a CUDA device the ROI CNN's forward and backward are the kernels
(ops/cuda_cnn.py); the GRU is the plain scan, as in the JAX package, whose
GRU kernel is inference-only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.augment import AugmentConfig, augment_batch
from ..models.bigru import BiGRUClassifier, BiGRUConfig, jax_tree, tree_leaves
from ..ops._kernels import IMPLS


def smoothed_cross_entropy(logits: torch.Tensor, y: torch.Tensor,
                           num_classes: int, smoothing: float
                           ) -> torch.Tensor:
    """Mean cross entropy against one-hot targets smoothed as
    ``nn.CrossEntropyLoss(label_smoothing=smoothing)``."""
    onehot = F.one_hot(y.long(), num_classes).to(logits.dtype)
    target = onehot * (1.0 - smoothing) + smoothing / num_classes
    return -(target * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def resolve_roi_impl(roi_impl: str) -> str:
    """Check a TrainConfig ``roi_impl`` for the port. 'auto' runs the ROI CNN
    kernels (forward and weight gradients) on a CUDA device and the plain
    version on the CPU; 'kernel' and 'plain' force one. The JAX package's
    frames-per-step gate for 'auto' was measured on a TPU and does not
    apply. Its impl names raise."""
    if roi_impl not in IMPLS:
        raise ValueError(
            f"roi_impl={roi_impl!r} is not a value of the port's trainer; it "
            f"takes one of {IMPLS} (the JAX package's 'xla', 'grouped', "
            "'pallas' and 'fused' do not apply; see ROADMAP.md)")
    return roi_impl


class Optimizer:
    """Adam after a global-norm clip of the gradients, as the JAX package's
    ``optax.chain(clip_by_global_norm(max_norm), adam(lr))``: the gradients
    are scaled by max_norm / g_norm only when g_norm >= max_norm (optax's
    rule; ``torch.nn.utils.clip_grad_norm_`` differs), then
    ``torch.optim.Adam`` with optax's defaults (betas 0.9, 0.999, eps 1e-8)
    steps."""

    def __init__(self, model: BiGRUClassifier, lr: float,
                 grad_clip_norm: float = 1.0):
        self.model = model
        self.params = list(model.parameters())
        self.max_norm = grad_clip_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def clip(self) -> torch.Tensor:
        """Clip the gradients in place; returns their global norm (on the
        device, with no host sync)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        g_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        keep = g_norm < self.max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / g_norm * self.max_norm))
        return g_norm

    def step(self) -> None:
        self.clip()
        self.adam.step()

    # --- the JAX package's optimizer-state leaves -------------------------
    # jax.tree.leaves(chain(clip_by_global_norm, adam).init(params)) is
    # [count, *mu leaves, *nu leaves], each moment in the parameter tree's
    # leaf order and JAX layout (train/loop.py:321 of the JAX package).

    def state_arrays(self) -> list[np.ndarray]:
        """Adam's step, exp_avg and exp_avg_sq as the JAX package's list of
        optimizer-state leaves (numpy)."""
        named = dict(self.model.named_parameters())
        state = self.adam.state
        step = next((float(state[p]["step"]) for p in self.params
                     if p in state), 0.0)

        def moments(key):
            tree = jax_tree({n: state[p][key] if p in state
                             else torch.zeros_like(p)
                             for n, p in named.items()}, self.model.cfg)
            return [t.detach().cpu().numpy() for t in tree_leaves(tree)]

        return ([np.asarray(int(step), np.int32)] + moments("exp_avg")
                + moments("exp_avg_sq"))

    def load_state_arrays(self, leaves: list) -> None:
        """Set Adam's state from the JAX package's optimizer-state leaves
        (as :meth:`state_arrays` writes them)."""
        named = dict(self.model.named_parameters())
        n = len(named)
        if len(leaves) != 1 + 2 * n:
            raise ValueError(f"expected 1 + 2 * {n} optimizer-state leaves, "
                             f"got {len(leaves)}")
        step = float(np.asarray(leaves[0]))
        state = self.adam.state
        for p in named.values():
            state[p] = {"step": torch.tensor(step, dtype=torch.float32),
                        "exp_avg": torch.zeros_like(p),
                        "exp_avg_sq": torch.zeros_like(p)}
        for key, arrays in (("exp_avg", leaves[1:1 + n]),
                            ("exp_avg_sq", leaves[1 + n:])):
            views = tree_leaves(jax_tree({nm: state[p][key]
                                          for nm, p in named.items()},
                                         self.model.cfg))
            for v, a in zip(views, arrays):
                a = torch.as_tensor(np.asarray(a, np.float32))
                if tuple(v.shape) != tuple(a.shape):
                    raise ValueError(f"optimizer-state leaf of shape "
                                     f"{tuple(a.shape)} for a parameter of "
                                     f"shape {tuple(v.shape)}")
                v.copy_(a)


def make_optimizer(model: BiGRUClassifier, lr: float,
                   grad_clip_norm: float = 1.0) -> Optimizer:
    """Adam + global-norm clipping (train_model_official.py:403,438)."""
    return Optimizer(model, lr, grad_clip_norm)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    model: BiGRUConfig
    label_smoothing: float = 0.05
    augment: Optional[AugmentConfig] = None
    roi_impl: str = "auto"


def train_step(model: BiGRUClassifier, opt: Optimizer, scfg: StepConfig,
               X: torch.Tensor, lengths: torch.Tensor,
               roi: Optional[torch.Tensor], y: torch.Tensor,
               generator: torch.Generator) -> dict:
    """One official train step on a gathered batch; the augmentation and
    dropout draws come from ``generator``. Returns the batch's loss and
    accuracy as device tensors (no host sync)."""
    if scfg.augment is not None:
        X, lengths = augment_batch(generator, X, lengths, scfg.augment)
    logits = model.train_forward(X, lengths, roi, train=True,
                                 generator=generator, roi_impl=scfg.roi_impl)
    loss = smoothed_cross_entropy(logits, y, scfg.model.num_classes,
                                  scfg.label_smoothing)
    opt.zero_grad()
    loss.backward()
    opt.step()
    acc = (logits.detach().argmax(-1) == y).to(torch.float32).mean()
    return {"loss": loss.detach(), "acc": acc}


@torch.no_grad()
def eval_step(model: BiGRUClassifier, scfg: StepConfig, X, lengths, roi,
              y) -> dict:
    """Loss, accuracy and predictions of the training-path forward in eval
    mode (the reference validates with model.eval() on the standardized ROI
    path, train_model_official.py:449-475); on a CUDA device it runs the
    inference kernels."""
    logits = model.train_forward(X, lengths, roi, train=False,
                                 roi_impl=scfg.roi_impl)
    loss = smoothed_cross_entropy(logits, y, scfg.model.num_classes,
                                  scfg.label_smoothing)
    pred = logits.argmax(-1)
    return {"loss": loss, "acc": (pred == y).to(torch.float32).mean(),
            "pred": pred}

"""CTC: the loss and dictionary word scoring (port of the JAX ops/ctc.py).

The reference trains with ``nn.CTCLoss`` (inactive/train_model.py:222) and
scores dictionary words with a Python double loop
(inactive/train_model.py:167-189). Both are one alpha lattice here, run as
a loop over time on (..., S) tensors, S = 2 L + 1 extended states,
differentiable through autograd. Every lattice (the loss's samples, the
dictionary's words, a batch of clips times a dictionary chunk) runs through
one per-sample NLL function, :func:`_ctc_nll_single`, as the JAX package
insists: a second copy could let the training loss and the dictionary
sweep diverge.

The semantics are the JAX package's:

- ``NEG_INF = -1e30`` and not ``-inf``, with its ``m_safe`` guard: a state
  no path reaches holds -1e30, an impossible word (one that needs more
  frames than it has) scores about -1e30 and not NaN, and no gradient is
  NaN (with ``-inf`` the logsumexp's gradient is NaN where every branch is
  ``-inf``). ``zero_infinity`` drops an NLL of 1e30 or more.
- The emissions for every step are gathered once before the loop (the
  JAX package's one-hot einsum at HIGHEST precision, which is exact, as
  ``torch.gather`` is). The JAX package pads the lattice axis to 128 lanes
  for the TPU's compiler; the padded states never reach the real lattice,
  and nothing is padded here.

On a card each step of the loop is a handful of small elementwise
launches, so a lattice of T steps costs about T times the host's launch
time, whatever its width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _extend_labels(labels: torch.Tensor, blank: int) -> torch.Tensor:
    """(..., L) labels -> (..., 2L+1) blank-interleaved extended sequence."""
    blanks = torch.full_like(labels, blank)
    inter = torch.stack([blanks, labels], dim=-1).flatten(-2)
    return F.pad(inter, (0, 1), value=blank)


def _shift2(ext: torch.Tensor, blank: int) -> torch.Tensor:
    """ext shifted right by two states (the label before the previous),
    blank-filled."""
    return F.pad(ext[..., :-2], (2, 0), value=blank)


def _ctc_alphas(emit: torch.Tensor, input_lengths: torch.Tensor,
                allow_skip: torch.Tensor) -> torch.Tensor:
    """The CTC forward recursion. emit: (..., T, S) log-probabilities of each
    extended state's class at each step; input_lengths: (...); allow_skip:
    (..., S) bool. Returns the final alpha (..., S), each sample's lattice
    frozen from its input length on."""
    T = emit.shape[-2]
    S = emit.shape[-1]
    alpha = torch.full_like(emit[..., 0, :], NEG_INF)
    alpha[..., 0] = emit[..., 0, 0]
    if S > 1:
        alpha[..., 1] = emit[..., 0, 1]
    neg = torch.full_like(alpha, NEG_INF)
    for t in range(1, T):
        shifted = F.pad(alpha, (2, 0), value=NEG_INF)
        a0 = alpha
        a1 = shifted[..., 1:S + 1]
        a2 = torch.where(allow_skip, shifted[..., :S], neg)
        m = torch.maximum(torch.maximum(a0, a1), a2)
        m_safe = torch.clamp(m, min=NEG_INF)
        new = m_safe + torch.log(torch.exp(a0 - m_safe)
                                 + torch.exp(a1 - m_safe)
                                 + torch.exp(a2 - m_safe)) + emit[..., t, :]
        new = torch.where(m <= NEG_INF, neg, new)
        alpha = torch.where((t < input_lengths)[..., None], new, alpha)
    return alpha


def _ctc_nll_single(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                    labels: torch.Tensor, label_lengths: torch.Tensor,
                    blank: int = 0) -> torch.Tensor:
    """Per-sample CTC NLL: THE lattice setup and readout, shared by the
    loss (:func:`ctc_loss`) and the dictionary scorers
    (:func:`ctc_word_logprob`, :func:`ctc_word_logprobs_batch`,
    :func:`ctc_word_logprobs_clips`).

    log_probs: (..., T, C) log-softmax; input_lengths: (...); labels:
    (..., L) padded class ids; label_lengths: (...). The leading dimensions
    broadcast against each other (a clip against a dictionary's words
    without copying the clip). Returns the NLL over the broadcast shape."""
    T = log_probs.shape[-2]
    input_lengths = input_lengths.to(log_probs.device)
    label_lengths = label_lengths.to(log_probs.device)
    labels = labels.to(device=log_probs.device, dtype=torch.int64)
    batch = torch.broadcast_shapes(log_probs.shape[:-2], labels.shape[:-1],
                                   input_lengths.shape, label_lengths.shape)
    ext = _extend_labels(labels, blank).expand(*batch, -1)  # (..., S)
    S = ext.shape[-1]
    s_idx = torch.arange(S, device=ext.device)
    # a label state may skip the blank before it iff its class differs from
    # the label before (the standard CTC transition rule)
    allow_skip = (s_idx >= 2) & (ext != blank) & (ext != _shift2(ext, blank))
    emit = torch.gather(log_probs.expand(*batch, T, -1), -1,
                        ext.unsqueeze(-2).expand(*batch, T, S))
    alpha = _ctc_alphas(emit, input_lengths.expand(batch), allow_skip)
    # states past each sample's extended length are not in its lattice
    label_lengths = label_lengths.expand(batch).to(torch.int64)
    alpha = torch.where(s_idx < (2 * label_lengths[..., None] + 1), alpha,
                        torch.full_like(alpha, NEG_INF))
    end = 2 * label_lengths  # the final blank's state
    a_last = torch.gather(alpha, -1, end[..., None])[..., 0]
    a_prev = torch.gather(alpha, -1, (end - 1).clamp(min=0)[..., None])[..., 0]
    # an empty target's only path ends in the final blank
    a_prev = torch.where(label_lengths > 0, a_prev,
                         torch.full_like(a_prev, NEG_INF))
    return -torch.logaddexp(a_last, a_prev)


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor, *,
             blank: int = 0, zero_infinity: bool = True) -> torch.Tensor:
    """Batched CTC negative log-likelihood, as
    ``nn.CTCLoss(reduction='mean')``: each sample's NLL over its target
    length, averaged over the batch.

    log_probs: (B, T, C) log-softmax; input_lengths: (B,); labels: (B,
    L_max) padded label ids; label_lengths: (B,)."""
    nll = _ctc_nll_single(log_probs, input_lengths, labels, label_lengths,
                          blank)
    if zero_infinity:
        nll = torch.where(torch.isfinite(nll) & (nll < -NEG_INF), nll,
                          torch.zeros_like(nll))
    lens = label_lengths.to(device=nll.device, dtype=nll.dtype)
    return (nll / lens.clamp(min=1.0)).mean()


def ctc_word_logprob(log_probs_tc: torch.Tensor, word_ids: torch.Tensor,
                     word_len, input_length, blank: int = 0) -> torch.Tensor:
    """log P(word | frames) under CTC for one word: the reference's double
    loop (inactive/train_model.py:167-189). log_probs_tc: (T, C);
    ``word_ids`` may be padded, ``word_len`` gives its true length."""
    dev = log_probs_tc.device
    return -_ctc_nll_single(log_probs_tc, torch.as_tensor(input_length,
                                                          device=dev),
                            torch.as_tensor(word_ids, device=dev),
                            torch.as_tensor(word_len, device=dev), blank)


def ctc_word_logprobs_batch(log_probs_tc: torch.Tensor,
                            dict_ids: torch.Tensor, dict_lens: torch.Tensor,
                            input_length, blank: int = 0) -> torch.Tensor:
    """Every dictionary word against one clip at once. log_probs_tc: (T, C);
    dict_ids: (N, L_max) padded class ids; dict_lens: (N,). Returns (N,)
    log-probabilities."""
    dev = log_probs_tc.device
    return -_ctc_nll_single(log_probs_tc,
                            torch.as_tensor(input_length, device=dev),
                            torch.as_tensor(dict_ids, device=dev),
                            torch.as_tensor(dict_lens, device=dev), blank)


def ctc_word_logprobs_clips(log_probs: torch.Tensor,
                            input_lengths: torch.Tensor,
                            dict_ids: torch.Tensor, dict_lens: torch.Tensor,
                            blank: int = 0) -> torch.Tensor:
    """A batch of clips against a dictionary (chunk) in one lattice: the
    JAX package's ``vmap`` of :func:`ctc_word_logprobs_batch` over clips.
    log_probs: (B, T, C); input_lengths: (B,); dict_ids: (n, L_max);
    dict_lens: (n,). Returns (B, n). The gathered emissions are one
    (B, n, T, 2 L_max + 1) f32 tensor, the sweep's largest allocation."""
    dev = log_probs.device
    lengths = torch.as_tensor(input_lengths, device=dev)
    return -_ctc_nll_single(log_probs[:, None], lengths[:, None],
                            torch.as_tensor(dict_ids, device=dev),
                            torch.as_tensor(dict_lens, device=dev), blank)


def length_prior_penalty(scores: torch.Tensor, dict_lens: torch.Tensor,
                         input_length, len_lambda: float,
                         len_per_char: int = 5) -> torch.Tensor:
    """The length prior on dictionary scores (inactive/train_model.py:
    245-248): score -= lambda * |T - len(word) * len_per_char|."""
    dev = scores.device
    expect = torch.as_tensor(dict_lens, device=dev).to(torch.float32) * \
        float(len_per_char)
    T = torch.as_tensor(input_length, device=dev).to(torch.float32)
    return scores - len_lambda * torch.abs(T - expect)

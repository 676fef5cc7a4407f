"""Checks of the ROI CNN weight-gradient kernel (csrc/roi_cnn_bwd.cu, K3)
that the training path never runs: its check entry, and the route its
gradient followed.

The kernel differentiates the branch its recompute of the forward took:
which element each 2x2 pool window passes on, and where each ReLU passes.
Its check entry (:func:`roi_cnn_bwd_check`, a separate instantiation of the
kernel) writes that :class:`Route` and the recomputed conv3 means.
:func:`roi_cnn_plain_routed` is the plain network along a given route, so
the kernel can be held to the plain version on its own branch;
:func:`route_gaps` says where a route leaves the plain forward's own
(:func:`plain_route`), and by how much: two f32 forwards that compute the
same function within rounding differ only at near-ties, by gaps of their
rounding, and never at an exact tie, where both take the first max.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_cnn
from .nn import conv2d_nhwc, dense, max_pool_2x2

# csrc/roi_cnn_bwd.cu write_route: a frame's codes1, mask1, codes2, mask2,
# mask3 (bytes)
ROUTE_PARTS = (("codes1", 24 * 48 * 2), ("mask1", 24 * 48),
               ("codes2", 12 * 24 * 4), ("mask2", 12 * 24 * 2),
               ("mask3", 12 * 24 * 4))
ROUTE_BYTES = sum(n for _, n in ROUTE_PARTS)


class Route(NamedTuple):
    """The decisions of the ROI CNN's forward that its gradient follows,
    NHWC as ``cuda_cnn.roi_cnn_plain``: each 2x2 pool window's argmax (0-3,
    its row-major position) after conv1 (N, 24, 48, 8) and conv2 (N, 12,
    24, 16), and where each ReLU passes (bool): the pooled conv1 (N, 24,
    48, 8) and conv2 (N, 12, 24, 16) maps, and conv3 (N, 12, 24, 24)."""

    arg1: torch.Tensor
    live1: torch.Tensor
    arg2: torch.Tensor
    live2: torch.Tensor
    live3: torch.Tensor


class Gap(NamedTuple):
    """Where a route leaves the plain forward's own at one layer's
    decisions: the number of differences, the largest gap among them (a
    share of the layer's largest magnitude in the frame), and how many of
    them lie at an exact tie (gap 0)."""

    diffs: int
    gap: float
    at_ties: int


def roi_cnn_bwd_check(roi_u8: torch.Tensor, dE: torch.Tensor,
                      flat: torch.Tensor, *, standardize: bool
                      ) -> tuple[torch.Tensor, torch.Tensor, Route]:
    """``cuda_cnn.roi_cnn_weight_grads`` through the backward kernel's
    check entry: the gradients; (N, 24) f32, the conv3 means (the fc's
    input) the kernel recomputed for each frame, which must be bitwise the
    forward kernel's; and the :class:`Route` the gradients followed, the
    recomputed forward's decisions."""
    N, dev = roi_u8.shape[0], roi_u8.device
    feat = torch.empty((N, cuda_cnn.CHANNELS[-1]), dtype=torch.float32,
                       device=dev)
    raw = torch.empty((N, ROUTE_BYTES), dtype=torch.uint8, device=dev)
    grads = cuda_cnn.roi_cnn_bwd_entry(roi_u8, dE, flat, standardize,
                                       feat, raw)
    return grads, feat, decode_route(raw)


def decode_route(raw: torch.Tensor) -> Route:
    """(N, ROUTE_BYTES) uint8 in write_route's layout -> :class:`Route`."""
    parts, o = {}, 0
    for name, n in ROUTE_PARTS:
        parts[name] = raw[:, o:o + n]
        o += n
    word = lambda name, dtype, mask: (parts[name].contiguous().view(dtype)
                                      .to(torch.int64) & mask)
    bits = lambda w, shape, n, width: ((w.view(*shape, 1) >> (
        width * torch.arange(n, device=w.device))) & (2 ** width - 1))
    N = raw.shape[0]
    c1, c2 = word("codes1", torch.int16, 0xFFFF), word("codes2", torch.int32,
                                                        0xFFFFFFFF)
    m1 = parts["mask1"].to(torch.int64)
    m2 = word("mask2", torch.int16, 0xFFFF)
    m3 = word("mask3", torch.int32, 0xFFFFFFFF)
    return Route(bits(c1, (N, 24, 48), 8, 2), bits(m1, (N, 24, 48), 8, 1) > 0,
                 bits(c2, (N, 12, 24), 16, 2), bits(m2, (N, 12, 24), 16, 1) > 0,
                 bits(m3, (N, 12, 24), 24, 1) > 0)


def _windows(y: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4, C): each 2x2 pool window's values
    in row-major order."""
    N, H, W, C = y.shape
    return y.reshape(N, H // 2, 2, W // 2, 2, C).permute(
        0, 1, 3, 2, 4, 5).reshape(N, H // 2, W // 2, 4, C)


def _plain_stages(roi_u8: torch.Tensor, params: dict,
                  standardize: bool) -> tuple:
    """``roi_cnn_plain``'s conv outputs (biases added, before ReLU and
    pool), in the parameters' dtype."""
    with torch.no_grad():
        x = cuda_cnn.preprocess_roi(roi_u8, standardize,
                                    params["fc"]["w"].dtype).unsqueeze(-1)
        c1 = conv2d_nhwc(x, params["conv0"])
        c2 = conv2d_nhwc(torch.relu(max_pool_2x2(c1)), params["conv1"])
        c3 = conv2d_nhwc(torch.relu(max_pool_2x2(c2)), params["conv2"])
    return c1, c2, c3


def plain_route(roi_u8: torch.Tensor, params: dict,
                standardize: bool = False) -> Route:
    """The :class:`Route` of ``roi_cnn_plain``'s own forward: the first max
    of each window (torch.argmax takes the first), ReLU > 0."""
    c1, c2, c3 = _plain_stages(roi_u8, params, standardize)
    return Route(_windows(c1).argmax(dim=3), max_pool_2x2(c1) > 0,
                 _windows(c2).argmax(dim=3), max_pool_2x2(c2) > 0, c3 > 0)


def route_gaps(roi_u8: torch.Tensor, params: dict, standardize: bool,
               route: Route) -> dict[str, Gap]:
    """Where ``route`` takes another branch than ``roi_cnn_plain``'s own
    forward (in the parameters' dtype; float64 is the reference), per
    decision, as a :class:`Gap`: a pool window's max minus the value the
    route took, or a ReLU input's |value| where the route disagrees on its
    sign, as a share of that layer's largest magnitude in the frame. A
    difference at gap 0 is an exact tie taken another way: a window passed
    on to another than its first max, or a ReLU passing at exactly 0."""
    c1, c2, c3 = _plain_stages(roi_u8, params, standardize)
    own = plain_route(roi_u8, params, standardize)
    frame_max = lambda v: v.abs().flatten(1).amax(1).clamp_min(
        torch.finfo(v.dtype).tiny).view(-1, *([1] * (v.ndim - 1)))
    out = {}
    for name, c, arg, arg_own in (("pool1", c1, route.arg1, own.arg1),
                                  ("pool2", c2, route.arg2, own.arg2)):
        w = _windows(c)
        gap = (w.gather(3, arg_own.unsqueeze(3))
               - w.gather(3, arg.unsqueeze(3))).squeeze(3) / frame_max(c)
        out[name] = (arg != arg_own, gap)
    for name, v, live, live_own in (
            ("relu1", max_pool_2x2(c1), route.live1, own.live1),
            ("relu2", max_pool_2x2(c2), route.live2, own.live2),
            ("relu3", c3, route.live3, own.live3)):
        out[name] = (live != live_own, v.abs() / frame_max(v))
    return {k: Gap(int(d.sum()), float(g[d].max()) if d.any() else 0.0,
                   int((d & (g == 0)).sum()))
            for k, (d, g) in out.items()}


def near_ties_only(gaps: dict[str, Gap], tol: float) -> bool:
    """Every difference of :func:`route_gaps` is a near-tie: a gap of at
    most ``tol``, and none at an exact tie."""
    return all(g.gap <= tol and g.at_ties == 0 for g in gaps.values())


def roi_cnn_plain_routed(roi_u8: torch.Tensor, params: dict,
                         standardize: bool, route: Route) -> torch.Tensor:
    """``roi_cnn_plain`` along a given :class:`Route`: each pool takes the
    window value the route names and each ReLU passes where the route
    says, so autograd differentiates the branch of the piecewise-linear
    network that route's forward took (with :func:`plain_route`'s own route
    it is ``roi_cnn_plain``, value and gradient)."""
    x = cuda_cnn.preprocess_roi(roi_u8, standardize,
                                params["fc"]["w"].dtype).unsqueeze(-1)
    pool = lambda y, arg, live: _windows(y).gather(
        3, arg.unsqueeze(3)).squeeze(3) * live
    x = pool(conv2d_nhwc(x, params["conv0"]), route.arg1, route.live1)
    x = pool(conv2d_nhwc(x, params["conv1"]), route.arg2, route.live2)
    x = conv2d_nhwc(x, params["conv2"]) * route.live3
    return dense(x.mean(dim=(1, 2)), params["fc"])

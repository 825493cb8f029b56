"""Z-buffered forward point splatting: plain PyTorch spec + CUDA kernels.

Port of ``kbe_tpu/ops/splat.py`` (the XLA scatter spec) and of the TPU
kernels that compute it on the main path: ``splat_posed.py::
_build_posed_kernel`` (the frame loop, C = 4) and ``splat_banded.py::
_build_banded_wide_kernel`` (the inpainting bootstrap, C = 68). Three
passes of the spec, four kernels in ``csrc/splat.cu``:

  zee:        each point writes the key 1e6 - f*b/(z+1e-7) to its corner of
              largest bilinear weight (ties NW, NE, SW, SE), keeping the min;
  degrid:     opposing-pair hole closing of the z-buffer;
  accumulate: each point adds w * payload and w to every in-image corner
              whose z-buffer it is within +1 of. On the card: ``count``
              counts those entries per pixel, ``place`` writes each (id
              4 i + k, weight) into its pixel's segment (the scan of the
              counts), and ``sum`` adds each pixel's entries in ascending
              id order, the order of the plain version's ``index_add_`` on
              the CPU (``count`` and ``place`` are one kernel,
              ``splat_route``).

On the card the front half is one call of three kernels: ``splat_fill``
(the z-buffer, and the count pass's counts), ``splat_zee`` and
``splat_degrid``.

The render is differentiable with respect to the payload, as the spec is
under ``jax.grad``: on the CPU through the plain version's ``index_add_``,
on the card through ``SplatFunction``, whose backward is the kernel
``splat_grad`` (``splat_grad_plain`` beside it): each point gathers
``w_k * g[p_k] / (W[p_k] + 1e-7)`` from its visible corners k, in NW, NE,
SW, SE order (the kernel projects a point once for all its channels, and
takes each quotient from its corner's reciprocal with two FMA corrections,
which round it as the division does). The points, the mask and the pose
get no gradient: a render whose ``xyz``, ``valid`` or ``pose`` requires
one raises.

``render_grids`` is the shared body of the grid-cloud entry points of
``splat_routed``, ``splat_banded`` and ``legacy``: the TPU package has a
kernel generation behind each, all computing this one function.

The wrappers below take the plain path only for CPU tensors; a CUDA tensor
launches the kernel or raises. Each wrapper counts the kernels it launches
in ``LAUNCHES``, keyed ``"<kernel>/c<C>"``: a render on the card launches
``fill``, ``zee``, ``degrid``, ``count``, ``place`` and ``sum`` once each
(a cloud of no points only ``fill``, ``degrid`` and ``sum``), and its
backward ``grad`` once.

The pose is a (5,) f32 tensor ``(sx, sy, sz, focal, focal * baseline)`` on
the points' device: every pass adds the shift to the points itself, so the
frame loop passes the pose-invariant cloud (x, y pre-scaled by z/(z+1e-7)
once per video, as ``apply_shift`` scales them) and each point's position
is one f32 add, as in the spec. The mask ``valid`` (N,) may be None: every
point is valid, and no mask is read.

The kernels never drop a point. Every pass is exact: the card's render
equals the plain version's on the CPU bit for bit, and is the same from
run to run.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple, Optional, Tuple

import torch

from kbe_torch.ops import _build
from kbe_torch.ops.geometry import project_points, splat_error, true_div

_ZFAR = 1000000.0

LAUNCHES: collections.Counter = collections.Counter()


def _count(kernel: str, c: int) -> None:
    LAUNCHES[f"{kernel}/c{c}"] += 1


# ---------------------------------------------------------------- plain spec

def _project(xyz, valid, pose, height: int, width: int):
    """Shift + pinhole projection + z key, in the spec's f32 order."""
    shifted = xyz + pose[:3]
    u, v, z_ok = project_points(shifted, height, width, pose[3])
    # pose[4] is focal * baseline, already rounded once to f32
    err = splat_error(shifted[:, 2], pose[4], 1.0)
    return u, v, err, z_ok if valid is None else z_ok & (valid > 0.0)


def _neighbor_weights(u, v):
    """Corner coords (N, 4) and bilinear weights (N, 4), order NW NE SW SE."""
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    w_nw = (x0 + 1.0 - u) * (y0 + 1.0 - v)
    w_ne = (u - x0) * (y0 + 1.0 - v)
    w_sw = (x0 + 1.0 - u) * (v - y0)
    w_se = (u - x0) * (v - y0)
    xi = torch.stack([x0, x0 + 1.0, x0, x0 + 1.0], dim=-1)
    yi = torch.stack([y0, y0, y0 + 1.0, y0 + 1.0], dim=-1)
    return xi, yi, torch.stack([w_nw, w_ne, w_sw, w_se], dim=-1)


def _flat_index(xi, yi, height: int, width: int, ok):
    """Row-major pixel index; outside/invalid -> the dead slot H*W."""
    inb = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height) & ok
    flat = yi.clamp(0, height - 1).long() * width \
        + xi.clamp(0, width - 1).long()
    return torch.where(inb, flat, torch.full_like(flat, height * width)), inb


def best_corner_index(u, v, height: int, width: int, ok):
    """Flat pixel index of each point's first corner of largest bilinear
    weight (NW, NE, SW, SE order, as ``jnp.argmax``), or the dead slot."""
    xi, yi, w = _neighbor_weights(u, v)
    best = torch.zeros_like(u, dtype=torch.long)
    for k in range(1, 4):
        best = torch.where(w[:, k] > torch.gather(w, 1, best[:, None])[:, 0],
                           k, best)
    best = best[:, None]
    flat, _ = _flat_index(torch.gather(xi, 1, best)[:, 0],
                          torch.gather(yi, 1, best)[:, 0], height, width, ok)
    return flat


def zee_plain(xyz, valid, pose, height: int, width: int) -> torch.Tensor:
    """Scatter-min z-buffer, (H, W) f32."""
    u, v, err, ok = _project(xyz, valid, pose, height, width)
    flat = best_corner_index(u, v, height, width, ok)
    zee = torch.full((height * width + 1,), _ZFAR, dtype=torch.float32,
                     device=xyz.device)
    zee.scatter_reduce_(0, flat, err, reduce="amin")
    return zee[:-1].reshape(height, width)


def degrid_plain(zee: torch.Tensor) -> torch.Tensor:
    """Opposing-pair hole closing of an (H, W) z-buffer."""
    h, w = zee.shape
    p = torch.nn.functional.pad(zee, (1, 1, 1, 1), value=float("inf"))

    def nb(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    total = torch.zeros_like(zee)
    count = torch.zeros_like(zee)
    for dx, dy in ((1, 0), (0, 1), (1, 1), (1, -1)):
        one = nb(dy, dx)
        two = nb(-dy, -dx)
        good = (zee >= one + 1.0) & (zee >= two + 1.0)
        total = total + torch.where(good, one + two, torch.zeros_like(zee))
        count = count + torch.where(good, torch.full_like(zee, 2.0),
                                    torch.zeros_like(zee))
    avg = total / torch.clamp(count, min=1.0)
    return torch.where(count > 0.0, torch.minimum(zee, avg), zee)


def accumulate_plain(xyz, valid, payload, pose, zee, height: int,
                     width: int) -> torch.Tensor:
    """Weighted 4-corner scatter-add; returns the raw (H*W, C+1) sums."""
    n, c = payload.shape
    u, v, err, ok = _project(xyz, valid, pose, height, width)
    xi, yi, w = _neighbor_weights(u, v)
    flat, inb = _flat_index(xi, yi, height, width, ok[:, None])
    zflat = zee.reshape(-1)
    zn = torch.where(inb, zflat[flat.clamp(max=height * width - 1)],
                     torch.full_like(w, -float("inf")))
    vis = inb & (err[:, None] <= zn + 1.0)
    weights = torch.where(vis, w, torch.zeros_like(w))
    ones = torch.ones((n, 1), dtype=payload.dtype, device=payload.device)
    full = torch.cat([payload, ones], dim=-1)
    idx = torch.where(vis, flat, torch.full_like(flat, height * width))
    vals = (weights[..., None] * full[:, None, :]).reshape(-1, c + 1)
    out = torch.zeros((height * width + 1, c + 1), dtype=torch.float32,
                      device=payload.device)
    out.index_add_(0, idx.reshape(-1), vals)
    return out[:-1]


def splat_grad_plain(xyz, valid, pose, zee, existing, grad, height: int,
                     width: int) -> torch.Tensor:
    """The payload's (N, C) gradient of the normalised render, given the
    (H*W, C) gradient ``grad`` of the render, the degridded ``zee`` and the
    weight sums ``existing`` (H*W values) of its forward: for each point,
    the sum over its visible corners k, in NW, NE, SW, SE order from zero,
    of ``w_k * (grad[p_k] / (existing[p_k] + 1e-7))``. The CPU's autograd
    of ``accumulate_plain`` and the normalisation computes the same
    products and quotients (``tests/test_torch_splat_grad.py``)."""
    hw = height * width
    u, v, err, ok = _project(xyz, valid, pose, height, width)
    xi, yi, w = _neighbor_weights(u, v)
    flat, inb = _flat_index(xi, yi, height, width, ok[:, None])
    safe = flat.clamp(max=hw - 1)
    zn = torch.where(inb, zee.reshape(-1)[safe],
                     torch.full_like(w, -float("inf")))
    vis = inb & (err[:, None] <= zn + 1.0)
    quotient = grad / (existing.reshape(hw, 1) + 1e-7)
    out = torch.zeros((xyz.shape[0], grad.shape[1]), dtype=torch.float32,
                      device=grad.device)
    for k in range(4):
        term = w[:, k:k + 1] * quotient[safe[:, k]]
        out = out + torch.where(vis[:, k:k + 1], term,
                                torch.zeros_like(term))
    return out


# ------------------------------------------------------------ CUDA wrappers

def _check_inputs(xyz, valid, pose, payload=None):
    for name, t in (("xyz", xyz), ("valid", valid), ("pose", pose),
                    ("payload", payload)):
        if t is None:
            continue
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 CUDA tensor")
        if t.device != xyz.device:
            raise ValueError(f"{name} is on {t.device}, xyz on {xyz.device}")
    n = xyz.shape[0]
    if (xyz.shape != (n, 3) or pose.shape != (5,)
            or (valid is not None and valid.shape != (n,))):
        raise ValueError("expected xyz (N, 3), valid (N,) or None, pose (5,)")
    if n > _MAX_POINTS:
        raise ValueError(f"{n} points: the entry ids 4 i + k need N < 2^30")
    if payload is not None:
        if payload.ndim != 2 or payload.shape[0] != n:
            raise ValueError("expected payload (N, C)")
        if payload.shape[1] > _MAX_CHANNELS:
            raise ValueError(f"C={payload.shape[1]}: the sum pass takes at "
                             f"most {_MAX_CHANNELS} channels")


def _check_zee(zee, height: int, width: int) -> None:
    if (not zee.is_cuda or zee.dtype != torch.float32
            or zee.shape != (height, width) or not zee.is_contiguous()):
        raise ValueError("expected a contiguous (H, W) f32 CUDA z-buffer")


def _check_counts(counts, height: int, width: int) -> None:
    if (not counts.is_cuda or counts.dtype != torch.int32
            or counts.shape != (height * width,)
            or not counts.is_contiguous()):
        raise ValueError("expected the contiguous (H*W,) int32 CUDA counts "
                         "of count_cuda")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# the entry ids 4 i + k fill the high word of a key
_MAX_POINTS = (1 << 30) - 1
# the sum pass's long segments: a thread sums at most 4 channels of 256
_MAX_CHANNELS = 1024

# The launches, on checked inputs: ``lib`` the loaded library, ``stream``
# the current stream of the inputs' device. ``splat`` checks once and calls
# them in a row; the public wrappers below check their own inputs.


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _front(lib, stream, xyz, valid, pose, height, width, c, counts=None):
    keys = torch.empty((height * width,), dtype=torch.int32,
                       device=xyz.device)
    zee = torch.empty((height, width), dtype=torch.float32, device=xyz.device)
    _count("fill", c)
    if xyz.shape[0]:
        _count("zee", c)
    _count("degrid", c)
    _build.check(lib.kbe_splat_front(
        xyz.data_ptr(), _ptr(valid), pose.data_ptr(), xyz.shape[0], height,
        width, keys.data_ptr(), zee.data_ptr(), _ptr(counts), stream),
        "splat_front")
    return keys, zee


def _route(lib, stream, xyz, valid, pose, zee, height, width, cursor, keys,
           kernel, c):
    if xyz.shape[0]:  # kbe_splat_route launches nothing for no points
        _count(kernel, c)
    _build.check(lib.kbe_splat_route(
        xyz.data_ptr(), _ptr(valid), pose.data_ptr(), zee.data_ptr(),
        xyz.shape[0], height, width, cursor.data_ptr(), _ptr(keys), stream),
        "splat_route")


def _count_entries(lib, stream, xyz, valid, pose, zee, height, width, c,
                   counts):
    """``counts``: (H*W,) int32 zeros, which gain the entries."""
    _route(lib, stream, xyz, valid, pose, zee, height, width, counts, None,
           "count", c)
    return counts


def _place(lib, stream, xyz, valid, pose, zee, counts, height, width, c):
    # the exclusive scan, as segment ends that the kernel counts down
    cursor = torch.cumsum(counts, 0, dtype=torch.int32)
    keys = torch.empty((max(4 * xyz.shape[0], 1),), dtype=torch.int64,
                       device=xyz.device)
    _route(lib, stream, xyz, valid, pose, zee, height, width, cursor, keys,
           "place", c)
    return cursor, keys


def _sum(lib, stream, payload, counts, starts, keys, height, width,
         normalize):
    c = payload.shape[1]
    if payload.data_ptr() % 16:
        payload = payload.clone()  # C = 4 rows are read 16 B at a time
    scratch = torch.empty_like(keys)
    out = torch.empty((height * width, c + 1), dtype=torch.float32,
                      device=payload.device)
    _count("sum", c)
    _build.check(lib.kbe_splat_sum(
        payload.data_ptr(), counts.data_ptr(), starts.data_ptr(),
        keys.data_ptr(), scratch.data_ptr(), c, height, width,
        int(normalize), out.data_ptr(), stream), "splat_sum")
    return out


def _accumulate(lib, stream, xyz, valid, payload, pose, zee, height, width,
                normalize, counts):
    c = payload.shape[1]
    counts = _count_entries(lib, stream, xyz, valid, pose, zee, height,
                            width, c, counts)
    starts, keys = _place(lib, stream, xyz, valid, pose, zee, counts, height,
                          width, c)
    return _sum(lib, stream, payload, counts, starts, keys, height, width,
                normalize)


def _grad(lib, stream, xyz, valid, pose, zee, existing, grad, height, width):
    n, c = xyz.shape[0], grad.shape[1]
    out = torch.empty((n, c), dtype=torch.float32, device=xyz.device)
    if n and c:  # kbe_splat_grad launches nothing for no points
        _count("grad", c)
    _build.check(lib.kbe_splat_grad(
        xyz.data_ptr(), _ptr(valid), pose.data_ptr(), zee.data_ptr(),
        existing.data_ptr(), grad.data_ptr(), n, c, height, width,
        out.data_ptr(), stream), "splat_grad")
    return out


def front_cuda(xyz, valid, pose, height: int, width: int, c: int,
               counts: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernels ``splat_fill``, ``splat_zee`` and ``splat_degrid``, one
    call: the front half. Returns the (H*W,) int32 key-encoded z-buffer
    (``zee_plain`` once decoded) and its (H, W) f32 degridded copy
    (``degrid_plain`` of it). ``valid`` may be None. ``counts``, an
    (H*W,) int32 CUDA buffer, is zeroed for the count pass. ``c`` only
    names the kernels in ``LAUNCHES``."""
    _check_inputs(xyz, valid, pose)
    if counts is not None:
        _check_counts(counts, height, width)
    return _front(_build.lib("splat"), _stream(xyz), xyz, valid, pose,
                  height, width, c, counts)


def _zeroed_counts(counts, xyz, height: int, width: int) -> torch.Tensor:
    if counts is None:
        return torch.zeros((height * width,), dtype=torch.int32,
                           device=xyz.device)
    _check_counts(counts, height, width)
    return counts


def count_cuda(xyz, valid, pose, zee, height: int, width: int, c: int,
               counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel ``splat_route``, counting: the (H*W,) int32 number of each
    pixel's entries, in-image corners of valid points that pass the z test
    against the degridded ``zee``. ``counts``: (H*W,) int32 zeros to count
    into, as ``front_cuda`` leaves them; None allocates them."""
    _check_inputs(xyz, valid, pose)
    _check_zee(zee, height, width)
    counts = _zeroed_counts(counts, xyz, height, width)
    return _count_entries(_build.lib("splat"), _stream(xyz), xyz, valid,
                          pose, zee, height, width, c, counts)


def place_cuda(xyz, valid, pose, zee, counts: torch.Tensor, height: int,
               width: int, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``splat_route``, placing: each pixel's entries as int64 keys
    (id 4 i + k high, weight low), unordered, in its segment of ``keys``
    (room for 4 N); returns (starts (H*W,), keys)."""
    _check_inputs(xyz, valid, pose)
    _check_zee(zee, height, width)
    _check_counts(counts, height, width)
    return _place(_build.lib("splat"), _stream(xyz), xyz, valid, pose, zee,
                  counts, height, width, c)


def sum_cuda(payload, counts, starts, keys, height: int, width: int,
             normalize: bool = False) -> torch.Tensor:
    """Kernel ``splat_sum``: every pixel's entries in ascending id order.
    Returns (H*W, C+1) f32: the sums of w * payload and of w, or with
    ``normalize`` the payload sums over (w sum + 1e-7) and the w sum. Sorts
    long segments of ``keys`` in place (the same keys, so a rerun gives the
    same sums)."""
    if (not payload.is_cuda or payload.dtype != torch.float32
            or payload.ndim != 2 or not payload.is_contiguous()):
        raise ValueError("payload must be a contiguous (N, C) f32 CUDA "
                         "tensor")
    if payload.shape[1] > _MAX_CHANNELS:
        raise ValueError(f"C={payload.shape[1]}: the sum pass takes at most "
                         f"{_MAX_CHANNELS} channels")
    _check_counts(counts, height, width)
    _check_counts(starts, height, width)
    if keys.dtype != torch.int64 or keys.device != payload.device:
        raise ValueError("expected the int64 keys of place_cuda")
    return _sum(_build.lib("splat"), _stream(payload), payload, counts,
                starts, keys, height, width, normalize)


def accumulate_cuda(xyz, valid, payload, pose, zee, height: int,
                    width: int, normalize: bool = False,
                    counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel ``splat_route`` (count, then place) and ``splat_sum``: the
    (H*W, C+1) f32 sums of ``accumulate_plain`` (normalised as ``splat``
    does with ``normalize``), bit for bit. ``counts``: as ``count_cuda``
    takes them."""
    _check_inputs(xyz, valid, pose, payload)
    _check_zee(zee, height, width)
    counts = _zeroed_counts(counts, xyz, height, width)
    return _accumulate(_build.lib("splat"), _stream(xyz), xyz, valid,
                       payload, pose, zee, height, width, normalize, counts)


def grad_cuda(xyz, valid, pose, zee, existing, grad, height: int,
              width: int) -> torch.Tensor:
    """Kernel ``splat_grad``: ``splat_grad_plain`` on the card, bit for
    bit. ``existing``: the forward's (H*W,) or (H*W, 1) weight sums;
    ``grad``: (H*W, C) f32. Returns the (N, C) f32 gradient."""
    _check_inputs(xyz, valid, pose)
    _check_zee(zee, height, width)
    hw = height * width
    for name, t, shape in (("existing", existing, (hw,)),
                           ("grad", grad, (hw, grad.shape[-1]))):
        if (not t.is_cuda or t.dtype != torch.float32
                or not t.is_contiguous() or t.numel() != math.prod(shape)
                or t.device != xyz.device):
            raise ValueError(f"{name} must be a contiguous f32 CUDA tensor "
                             f"of {shape} elements on xyz's device")
    if grad.ndim != 2:
        raise ValueError("expected grad (H*W, C)")
    return _grad(_build.lib("splat"), _stream(xyz), xyz, valid, pose, zee,
                 existing, grad, height, width)


def splat_grad(xyz, valid, pose, zee, existing, grad, height: int,
               width: int) -> torch.Tensor:
    """The payload's gradient: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    if xyz.is_cuda:
        return grad_cuda(xyz, valid, pose, zee, existing, grad, height, width)
    return splat_grad_plain(xyz, valid, pose, zee, existing, grad, height,
                            width)


def decode_keys(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of the kernels' order-preserving float -> int32 encoding."""
    flipped = torch.where(keys < 0, keys ^ 0x7fffffff, keys)
    return flipped.view(torch.float32)


# ----------------------------------------------------------------- renderers

def _render(xyz, payload, valid, pose, height: int, width: int):
    """(rendered (H*W, C), existing (H*W, 1), degridded zee (H, W)) with no
    graph: the kernels for CUDA tensors (inputs checked), the plain passes
    for CPU ones."""
    c = payload.shape[1]
    if xyz.is_cuda:
        _check_inputs(xyz, valid, pose, payload)
        lib, stream = _build.lib("splat"), _stream(xyz)
        counts = torch.empty((height * width,), dtype=torch.int32,
                             device=xyz.device)
        _, zee = _front(lib, stream, xyz, valid, pose, height, width, c,
                        counts)
        # the sum pass divides as the plain version does, bit for bit
        acc = _accumulate(lib, stream, xyz, valid, payload, pose, zee,
                          height, width, True, counts)
        return acc[:, :c], acc[:, c:], zee
    zee = degrid_plain(zee_plain(xyz, valid, pose, height, width))
    acc = accumulate_plain(xyz, valid, payload, pose, zee, height, width)
    return acc[:, :c] / (acc[:, c:] + 1e-7), acc[:, c:], zee


class SplatFunction(torch.autograd.Function):
    """The render as an autograd node with respect to the payload: the
    forward is ``_render`` (six kernels on the card), the backward
    ``splat_grad`` (the kernel ``splat_grad`` on the card). It saves the
    points, mask, pose, degridded ``zee`` and weight sums; ``existing`` is
    not differentiable. ``splat`` takes it for CUDA tensors when a gradient
    is wanted; on CPU tensors it runs the plain versions, which the tests
    hold to the plain autograd."""

    @staticmethod
    def forward(ctx, payload, xyz, valid, pose, height: int, width: int):
        rendered, existing, zee = _render(xyz, payload, valid, pose, height,
                                          width)
        existing = existing.contiguous()
        ctx.mark_non_differentiable(existing)
        ctx.save_for_backward(xyz, valid, pose, zee, existing)
        ctx.size = (height, width)
        return rendered, existing

    @staticmethod
    def backward(ctx, grad_rendered, _grad_existing):
        xyz, valid, pose, zee, existing = ctx.saved_tensors
        grad = grad_rendered.float().contiguous()
        return (splat_grad(xyz, valid, pose, zee, existing, grad, *ctx.size),
                None, None, None, None, None)


def splat(xyz, payload, valid, pose, height: int,
          width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render one cloud at one pose.

    ``xyz`` (N, 3), ``payload`` (N, C), ``valid`` (N,) or None, ``pose``
    (5,), all f32 on one device. Returns (rendered (H, W, C), existing (H,
    W, 1)). Differentiable with respect to ``payload`` (``SplatFunction`` on
    the card, plain autograd on the CPU); raises if ``xyz``, ``valid`` or
    ``pose`` requires a gradient. With no gradient wanted (no grad mode,
    inference mode, or a payload that needs none) nothing is saved.
    """
    c = payload.shape[1]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (xyz, valid, pose)):
        raise ValueError("the splat is differentiable only with respect to "
                         "the payload: xyz, valid and pose must not require "
                         "a gradient")
    if xyz.is_cuda and torch.is_grad_enabled() and payload.requires_grad:
        rendered, existing = SplatFunction.apply(payload, xyz, valid, pose,
                                                 height, width)
    else:
        rendered, existing, _ = _render(xyz, payload, valid, pose, height,
                                        width)
    return (rendered.reshape(height, width, c),
            existing.reshape(height, width, 1))


def make_pose(shift: torch.Tensor, focal, baseline) -> torch.Tensor:
    """(sx, sy, sz, focal, focal * baseline) as a (5,) f32 tensor on the
    shift's device (focal*baseline rounded once to f32, as the spec)."""
    f = torch.as_tensor(focal, dtype=torch.float32, device=shift.device)
    return torch.stack([shift[0], shift[1], shift[2], f,
                        f * baseline]).to(torch.float32).contiguous()


def render_pointcloud(xyz: torch.Tensor, data: torch.Tensor, height: int,
                      width: int, focal, baseline,
                      valid: Optional[torch.Tensor] = None):
    """``kbe_tpu.ops.splat.render_pointcloud``: (B, N, 3) points, (B, N, C)
    payload, optional (B, N) mask -> ((B, H, W, C), (B, H, W, 1))."""
    zero = torch.zeros(3, dtype=torch.float32, device=xyz.device)
    pose = make_pose(zero, focal, baseline)
    outs = [splat(xyz[b].float().contiguous(), data[b].float().contiguous(),
                  None if valid is None else valid[b].float().contiguous(),
                  pose, height, width)
            for b in range(xyz.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def render_grids(xyz: torch.Tensor, data: torch.Tensor, height: int,
                 width: int, focal, baseline,
                 valid: Optional[torch.Tensor] = None):
    """Render stacked pixel-grid clouds whose shift is already applied: the
    one body behind every ``render_grids_*`` entry point.

    ``xyz`` (G, H, W, 3), ``data`` (G, H, W, C), ``valid`` (G, H, W) or None
    -> (rendered (1, H, W, C), existing (1, H, W, 1)). The cloud is
    flattened to contiguous f32 (N, 3), (N, C), (N,) and goes through
    ``splat``: the kernels for CUDA tensors."""
    if xyz.ndim != 4 or xyz.shape[-1] != 3:
        raise ValueError("expected xyz (G, H, W, 3)")
    if data.ndim != 4 or data.shape[:3] != xyz.shape[:3]:
        raise ValueError("expected data (G, H, W, C) on xyz's grid")
    if valid is not None and valid.shape != xyz.shape[:3]:
        raise ValueError("expected valid (G, H, W)")
    c = data.shape[-1]
    zero = torch.zeros(3, dtype=torch.float32, device=xyz.device)
    rendered, existing = splat(
        xyz.float().reshape(-1, 3).contiguous(),
        data.float().reshape(-1, c).contiguous(),
        None if valid is None else valid.float().reshape(-1).contiguous(),
        make_pose(zero, focal, baseline), height, width)
    return rendered[None], existing[None]


def check_fallback(fallback: str) -> None:
    """The ``fallback`` argument of the ``render_grids_fast*`` entry points
    chose what a TPU renderer did with points it could not route. These
    kernels never drop a point, so both values give the same render; any
    other value is a caller's mistake."""
    if fallback not in ("clip", "scatter"):
        raise ValueError(f"fallback must be 'clip' or 'scatter', got "
                         f"{fallback!r}")


def no_overflow(like: torch.Tensor) -> torch.Tensor:
    """The overflow flag of the grid renderers: a constant false 0-d bool
    tensor on ``like``'s device, because no point is ever dropped."""
    return torch.zeros((), dtype=torch.bool, device=like.device)


class PosedScene(NamedTuple):
    """Pose-invariant render state of a grid cloud, made once per video.

    ``xyz`` (N, 3) with x, y pre-scaled by z/(z+1e-7), so ``x + sx`` equals
    ``apply_shift``; ``payload`` (N, C); ``valid`` (N,) 0/1: the whole
    grids, flattened. ``kept_xyz`` and ``kept_payload``: the valid points
    alone, in their order, which ``render_posed`` splats with no mask."""

    xyz: torch.Tensor
    payload: torch.Tensor
    valid: torch.Tensor
    kept_xyz: torch.Tensor
    kept_payload: torch.Tensor


def prepare_scene(xyz: torch.Tensor, data: torch.Tensor,
                  valid: torch.Tensor) -> PosedScene:
    """``xyz`` (G, H, W, 3), ``data`` (G, H, W, C), ``valid`` (G, H, W).

    Dropping the invalid points keeps the render bit for bit: they add no
    entry, and the kept entries keep their ascending order, so each
    pixel's sum adds the same values in the same order."""
    z = xyz[..., 2].float()
    scale = true_div(z, z + 1e-7)
    pts = torch.stack([xyz[..., 0].float() * scale,
                       xyz[..., 1].float() * scale, z], dim=-1)
    c = data.shape[-1]
    pts = pts.reshape(-1, 3).contiguous()
    payload = data.float().reshape(-1, c).contiguous()
    valid = (valid > 0.0).float().reshape(-1).contiguous()
    kept = torch.nonzero(valid > 0.0)[:, 0]
    return PosedScene(pts, payload, valid, pts[kept].contiguous(),
                      payload[kept].contiguous())


def render_posed(scene: PosedScene, pose: torch.Tensor, height: int,
                 width: int):
    """Render the scene at ``pose`` (see ``make_pose``): what the spec gives
    for ``apply_shift(xyz, shift)`` at that focal."""
    return splat(scene.kept_xyz, scene.kept_payload, None, pose, height,
                 width)

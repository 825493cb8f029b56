"""The partial convolution's one-channel masks and its mask side
(``kbe_torch/ops/pconv.py``), on the CPU with one thread.

A mask that is the same in every input channel is carried as one channel:
a ``PartialConv`` given it equals, bit for bit, the same conv given the
mask expanded to its input's channels, and ``PartialInpaint`` equals a
copy of itself that runs every conv on expanded masks. The kernel
``pconv`` cannot run here: its design (tiles of pixels, one thread a
pixel for the ratio, then the tile's values in vectors, in either layout)
is emulated in numpy f32 and held to the plain chain;
``tests/test_torch_cuda.py`` holds the kernel itself to the plain chain on
the card. The counters count the net's shapes: 57 partial convs a net
call, four calls a video in the dual colour/depth mode.
"""

import numpy as np
import pytest
import torch

from kbe_torch.config import EffectConfig
from kbe_torch.data import demo_scene_image
from kbe_torch.models import PartialConv, PartialInpaint
from kbe_torch.models.partial_conv import net_pconv_shapes
from kbe_torch.ops import pconv as P
from kbe_torch.pipeline import KenBurnsPipeline
from kbe_torch.utils import logging as trace

ROWS = (32, 64, 128, 256)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _binary_mask(b, h, w, seed):
    """A seeded 0/1 mask (b, 1, h, w) with a hole wider than a window."""
    g = torch.Generator().manual_seed(seed)
    mask = (torch.rand(b, 1, h, w, generator=g) > 0.35).float()
    mask[:, :, h // 4:3 * h // 4, w // 5:w // 2] = 0.0
    return mask


def _seeded(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    return module


@pytest.mark.parametrize("kernel,stride,masked", [
    (3, 1, True), (3, 2, True), (1, 1, True), (3, 1, False)],
    ids=["k3s1", "k3s2", "k1", "no_mask"])
def test_one_channel_mask_equals_the_expanded_mask(kernel, stride, masked):
    cin, cout, h, w = 6, 5, 13, 18
    conv = _seeded(PartialConv(cin, cout, kernel=kernel, stride=stride), 1)
    x = torch.randn(2, cin, h, w, generator=torch.Generator().manual_seed(2))
    mask = _binary_mask(2, h, w, 3) if masked else None
    full = (mask.expand(2, cin, h, w).contiguous() if masked
            else torch.ones(2, cin, h, w))
    with torch.no_grad():
        got, got_m = conv(x, mask)
        want, want_m = conv(x, full)
    assert torch.equal(got, want)
    assert torch.equal(got_m.expand(want_m.shape), want_m)
    if masked:
        assert got_m.shape == (2, 1) + tuple(got.shape[2:])
        assert 0.0 < float(got_m.mean()) < 1.0
    else:
        # ``mask=None``: border windows count only their pixels inside
        assert got_m.shape == got.shape and bool((got_m == 1.0).all())


def _expanded_forward(monkeypatch):
    """Make every ``PartialConv`` run on its mask expanded to its input's
    channels (a copy, as the published nets hold it) and hand its new mask
    back with the output's channels."""
    forward = PartialConv.forward

    def expanded(self, x, mask=None):
        if mask is not None and mask.shape[1] == 1 and x.shape[1] > 1:
            mask = mask.expand(x.shape).contiguous()
        out, new_mask = forward(self, x, mask)
        return out, new_mask.expand(out.shape).contiguous()

    monkeypatch.setattr(PartialConv, "forward", expanded)


@pytest.mark.parametrize("hw,dtype", [((32, 32), torch.float32),
                                      ((36, 44), torch.bfloat16)],
                         ids=["32x32-f32", "36x44-bf16"])
def test_partial_inpaint_equals_a_copy_on_expanded_masks(monkeypatch, hw,
                                                         dtype):
    net = _seeded(PartialInpaint(rows=(8, 12, 16, 20)), 4).to(dtype)
    g = torch.Generator().manual_seed(5)
    data = torch.randn(1, *hw, 68, generator=g)
    masks = _binary_mask(1, *hw, 6).permute(0, 2, 3, 1).contiguous()
    with torch.no_grad():
        got = net(data, masks)
        _expanded_forward(monkeypatch)
        want = net(data, masks)
    assert got[2].shape == (1, *hw, 1)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)


def emulate(raw, mask, bias, c_in, in_hw, k, stride, pad, nhwc, vec):
    """Kernel ``pconv``'s design in numpy f32: ``raw`` (B, C, H', W') as a
    torch tensor, ``mask`` (B, 1, H, W) or None; returns (out, new mask)
    as numpy (B, C, H', W') and (B, 1, H', W'). Every value is written
    once, at the offset its layout gives it."""
    f = np.float32
    b, c_out, ho, wo = raw.shape
    h, w = in_hw
    values = raw.float().permute(0, 2, 3, 1) if nhwc else raw.float()
    flat = values.contiguous().numpy().reshape(-1)
    m = None if mask is None else mask.numpy().reshape(b, h, w)
    bias = bias.float().numpy()
    out = np.full(flat.shape, np.nan, np.float32)
    new_mask = np.full((b, ho * wo), np.nan, np.float32)
    plane, tile = ho * wo, P.tile_pixels(c_out)
    window = f(c_in * k * k)
    for bi in range(b):
        for p0 in range(0, plane, tile):
            npx = min(tile, plane - p0)
            ratio = np.empty(npx, np.float32)
            nm = np.empty(npx, np.float32)
            for t in range(npx):       # one thread a pixel
                y, x = divmod(p0 + t, wo)
                total = f(0.0)
                for i in range(k):
                    yy = y * stride - pad + i
                    for j in range(k):
                        xx = x * stride - pad + j
                        if 0 <= yy < h and 0 <= xx < w:
                            total = f(total + (f(1.0) if m is None
                                               else m[bi, yy, xx]))
                cov = f(total * f(c_in))
                nm[t] = min(max(cov, f(0.0)), f(1.0))
                ratio[t] = f(f(window / f(cov + f(1e-8))) * nm[t])
                new_mask[bi, p0 + t] = nm[t]
            rows = npx // vec
            for t in range(npx * c_out // vec):   # a vector a thread
                if nhwc:
                    pix, ch = divmod(t * vec, c_out)
                    off = (bi * plane + p0 + pix) * c_out + ch
                else:
                    ch, r = divmod(t, rows)
                    pix = r * vec
                    off = (bi * c_out + ch) * plane + p0 + pix
                for lane in range(vec):
                    pl = pix if nhwc else pix + lane
                    cl = ch + lane if nhwc else ch
                    assert np.isnan(out[off + lane])
                    out[off + lane] = f(f(f(flat[off + lane] * ratio[pl])
                                          + bias[cl]) * nm[pl])
    out = out.reshape((b, ho, wo, c_out) if nhwc else (b, c_out, ho, wo))
    if nhwc:
        out = out.transpose(0, 3, 1, 2)
    return out, new_mask.reshape(b, 1, ho, wo)


@pytest.mark.parametrize("c_out,k,stride,hw,dtype,masked,nhwc,vec", [
    (8, 3, 1, (9, 12), torch.bfloat16, True, True, 4),
    (8, 3, 2, (9, 13), torch.float32, True, True, 4),
    (3, 3, 1, (7, 11), torch.bfloat16, True, True, 1),
    (5, 1, 1, (8, 10), torch.float32, False, False, 4),
    (4, 3, 2, (10, 10), torch.bfloat16, True, False, 1),
    (260, 3, 1, (6, 7), torch.bfloat16, True, True, 4),
], ids=["nhwc-bf16", "nhwc-s2-f32", "nhwc-c3", "nchw-nomask", "nchw-s2",
        "nhwc-260ch"])
def test_kernel_design_equals_the_plain_chain(c_out, k, stride, hw, dtype,
                                              masked, nhwc, vec):
    c_in, b, pad = 7, 2, k // 2
    h, w = hw
    ho, wo = P.out_size(h, k, stride, pad), P.out_size(w, k, stride, pad)
    g = torch.Generator().manual_seed(c_out * 100 + h)
    raw = (torch.randn(b, c_out, ho, wo, generator=g) * 30.0).to(dtype)
    if nhwc:
        raw = raw.contiguous(memory_format=torch.channels_last)
    mask = _binary_mask(b, h, w, 7) if masked else None
    bias = (torch.randn(c_out, generator=g)).to(dtype)
    coverage = P.coverage_plain(mask, c_in, hw, k, stride, pad,
                                torch.empty(b, c_in, h, w))
    want, want_m = P.mask_side_plain(raw, coverage, bias,
                                     float(c_in * k * k))
    got, got_m = emulate(raw, mask, bias, c_in, hw, k, stride, pad, nhwc,
                         vec)
    assert (P.tile_pixels(c_out) % vec == 0 and
            ((c_out % vec == 0) if nhwc else ((ho * wo) % vec == 0)))
    np.testing.assert_array_equal(got_m, want_m.numpy())
    np.testing.assert_array_equal(got, want.numpy())
    assert want.dtype == torch.float32 and 1.0 in got_m


def test_the_wrapper_refuses_cpu_tensors():
    raw = torch.zeros(1, 4, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        P.mask_side_cuda(raw, None, torch.zeros(4), 3, (8, 8), 3, 1, 1)


def _pconvs_by_hand(h, w):
    """(calls, out elems, mask pixels) of one ``PartialInpaint`` call at
    (h, w), h and w divisible by 8, listed conv by conv: (C_out, output
    pixels, input mask pixels or 0 where the conv is given no mask)."""
    px = [h * w >> (2 * r) for r in range(4)]
    convs = []

    def basic(c_in, c_mid, c_out, r, shortcut):
        convs.extend([(c_mid, px[r], px[r]), (c_out, px[r], px[r])])
        if shortcut:
            convs.append((c_out, px[r], 0))

    basic(68, 32, 32, 0, True)                        # the stem
    for _ in range(2):                                # down*x0, down*x1
        for r in (1, 2, 3):
            convs.extend([(ROWS[r], px[r], px[r - 1]),
                          (ROWS[r], px[r], px[r])])
    for _ in range(3):                                # blk*x1..3
        for r in range(4):
            basic(ROWS[r], ROWS[r], ROWS[r], r, False)
    for _ in range(2):                                # up*x2, up*x3
        for r in range(3):
            convs.extend([(ROWS[r], px[r], px[r]), (ROWS[r], px[r], px[r])])
    basic(32, 32, 3, 0, True)                         # the heads
    basic(32, 32, 1, 0, True)
    return (len(convs), sum(c * p for c, p, _ in convs),
            sum(p + m for _, p, m in convs))


def test_counters_count_the_dual_nets_shapes():
    """The dual colour/depth mode at 64^2: two bootstrap steps, each the
    colour and the depth net, so four calls of 57 partial convs."""
    assert _pconvs_by_hand(64, 64)[0] == 57
    pipe = KenBurnsPipeline.create(0, effect=EffectConfig(num_steps=2),
                                   device="cpu", partial_inpainting=True,
                                   inpaint_depth=True)
    image = demo_scene_image(64, 64)
    trace.reset_counters()
    with trace.tracing():
        frames = pipe(image)
    counts = trace.counters()
    trace.reset_counters()
    calls, elems, mask_px = _pconvs_by_hand(64, 64)
    assert counts["pconv_calls"] == 4 * calls
    assert counts["pconv_out_elems"] == 4 * elems
    assert counts["pconv_mask_px"] == 4 * mask_px
    assert frames.shape == (2, 64, 64, 3)
    # the net's convs, one by one, as a forward on the meta device meets
    # them
    shapes = net_pconv_shapes(64, 64)
    assert len(shapes) == calls
    assert sum(co * (h // s) * (w // s)
               for _, co, _, s, h, w, _ in shapes) == elems
    assert sum((h * w if masked else 0) + (h // s) * (w // s)
               for _, _, _, s, h, w, masked in shapes) == mask_px

"""The least bytes of the partial convs' mask side, from the program's
counters (``kbe_torch/models/partial_conv.py``): the yardstick of
``metrics/pconv_roofline.py``. Each byte in and out once, at the HBM rate
of ``counts.least_seconds``."""

from __future__ import annotations

# bytes a value of the weighted convolution's result, by the
# configuration's ``precision.inpaint``
RAW_BYTES = {"bfloat16": 2, "float32": 4}


def pconv_bytes(out_elems: float, mask_px: float,
                precision: str = "bfloat16") -> float:
    """The mask side of partial convs with ``out_elems`` output values
    (``pconv_out_elems``) and ``mask_px`` one-channel mask pixels in and
    out (``pconv_mask_px``): the convolution's result read once in the
    configuration's precision, the f32 output written once, and each mask
    pixel read or written once in f32."""
    return out_elems * (RAW_BYTES[precision] + 4) + 4 * mask_px

"""%: the partial convs' mask side's least time over its device time
(``pconv_mask_ms``), from the program slice. The least time counts the
weighted convolution's result read once in the configuration's inpainting
precision, the f32 output written once and the one-channel mask read and
written once, from the program's counters ``pconv_out_elems`` and
``pconv_mask_px`` (``benchmark/pconv_counts.py``), at the card's HBM rate
(``counts.least_seconds``). None where the program has no such span or
counters."""

from benchmark import counts
from benchmark.pconv_counts import pconv_bytes


def value(record):
    prog = record.get("program") or {}
    ms = ((prog.get("spans") or {}).get("bootstrap/pconv_mask")
          or {}).get("device_ms")
    tally = prog.get("counters") or {}
    elems, px = tally.get("pconv_out_elems"), tally.get("pconv_mask_px")
    if not ms or not elems or not px:
        return None
    precision = ((record.get("config") or {}).get("precision")
                 or {}).get("inpaint", "bfloat16")
    least = counts.least_seconds(pconv_bytes(elems, px, precision))
    return 100.0 * least / (ms / 1e3)

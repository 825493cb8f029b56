"""%: the fill stage's least time over the device time of every operation
it launches, over one video's poses (``fn.frame_stages``' ``fill``). The
least time counts the render and weight in and the filled frame out over
the region the crop reads, once each, at the card's HBM rate
(``counts.fill_bytes``)."""

from benchmark import counts

STAGES = ("fill",)  # the stage of ``fn.frame_stages`` it reads


def value(record):
    st = record.get("stages")
    if not st or not st["device_s"].get("fill") or "region" not in st:
        return None
    least = counts.least_seconds(counts.fill_bytes(st["region"])) \
        * st["frames"]
    return 100.0 * least / st["device_s"]["fill"]

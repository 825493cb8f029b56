"""%: the splat stage's least time over the device time of every operation
it launches, over one video's poses (``fn.frame_stages``' ``splat``). The
least time counts each valid point of the reference's cloud (xyz and rgb +
depth) read once and the render and weight planes written once, at the
card's HBM rate (``counts.splat_bytes``)."""

from benchmark import counts

STAGES = ("splat",)  # the stage of ``fn.frame_stages`` it reads


def value(record):
    st = record.get("stages")
    if not st or not st["device_s"].get("splat") or "valid_points" not in st:
        return None
    least = counts.least_seconds(counts.splat_bytes(
        st["valid_points"], st["height"], st["width"])) * st["frames"]
    return 100.0 * least / st["device_s"]["splat"]

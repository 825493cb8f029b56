"""%: the least time of the nets' FLOPs (f32 at the card's f32 peak
outside the tensor cores, since the depth nets run with TF32 off; bf16 at
its bf16 peak) over the wall time of the traced window's videos. FLOPs are
counted once a shape with ``FlopCounterMode`` over the reference's nets on
the meta device."""

from benchmark import counts


def value(record):
    videos = [v for v in record["window"]["videos"] if v["ok"]]
    wall = sum(v["latency_s"] for v in videos)
    if not wall:
        return None
    least = {}
    for v in videos:
        shape = (v["height"], v["width"])
        if shape not in least:
            least[shape] = counts.video_least_seconds(
                counts.net_flops(*shape, record["config"]))
    return 100.0 * sum(least[(v["height"], v["width"])]
                       for v in videos) / wall

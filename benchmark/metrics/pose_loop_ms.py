"""ms a frame: host clock around ``fn.render_frames`` (splat, fill,
quantise, crop, resize of every pose), ended by a synchronise, over the
frames of the traced window."""


def value(record):
    videos = [v for v in record["window"]["videos"]
              if v["ok"] and v["pieces_s"]]
    frames = sum(v["frames"] for v in videos)
    return (sum(v["pieces_s"]["pose_loop"] for v in videos) / frames * 1e3
            if frames else None)

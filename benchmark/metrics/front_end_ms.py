"""ms: host clock around ``fn.front_end`` (the photograph's copy to the
card, the depth nets, the inpainting bootstrap, the cloud and the poses),
ended by a synchronise, mean a video of the traced window."""


def value(record):
    pieces = [v["pieces_s"] for v in record["window"]["videos"]
              if v["ok"] and v["pieces_s"]]
    return (sum(p["front_end"] for p in pieces) / len(pieces) * 1e3
            if pieces else None)

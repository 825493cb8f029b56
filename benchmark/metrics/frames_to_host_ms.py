"""ms: host clock around the copy of a video's uint8 frames to the host
(``.cpu().numpy()``), mean a video of the traced window."""


def value(record):
    pieces = [v["pieces_s"] for v in record["window"]["videos"]
              if v["ok"] and v["pieces_s"]]
    return (sum(p["to_host"] for p in pieces) / len(pieces) * 1e3
            if pieces else None)

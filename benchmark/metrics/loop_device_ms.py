"""ms: device time a video of the operations launched in the program's
span ``kbe/pose_loop`` and the ``kbe/frame/...`` spans inside it (every
pose's splat, hole count, fill and finish), from the program slice
(``benchmark/program.py``: each operation charged to the innermost span
around its launch, so the reading does not follow the host's pace)."""


def value(record):
    prog = record.get("program") or {}
    spans = prog.get("spans")
    if not prog.get("device_ms") or "pose_loop" not in spans:
        return None
    return sum(row["device_ms"] for name, row in spans.items()
               if name == "pose_loop" or name.startswith("frame/"))

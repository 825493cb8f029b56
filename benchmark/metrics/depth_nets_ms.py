"""ms: device time a video of the operations launched in the program's
spans ``kbe/front_end/semantics``, ``kbe/front_end/disparity`` and
``kbe/front_end/refine`` (the f32 depth nets), from the program slice
(``benchmark/program.py``: each operation charged to the innermost span
around its launch)."""

NETS = ("front_end/semantics", "front_end/disparity", "front_end/refine")


def value(record):
    prog = record.get("program") or {}
    spans = prog.get("spans")
    if not prog.get("device_ms") or not all(name in spans for name in NETS):
        return None
    return sum(spans[name]["device_ms"] for name in NETS)

"""ms: device time a video of the operations launched in the program's
spans ``kbe/front_end/bootstrap`` (both steps) and the ``kbe/bootstrap/...``
spans inside them (``ContextNet``, the 68-channel splat, the median,
``Inpaint``, the unprojection), from the program slice
(``benchmark/program.py``). None where the effect runs no bootstrap
(dolly)."""


def value(record):
    prog = record.get("program") or {}
    spans = prog.get("spans")
    if not prog.get("device_ms") or "front_end/bootstrap" not in spans:
        return None
    return sum(row["device_ms"] for name, row in spans.items()
               if name == "front_end/bootstrap"
               or name.startswith("bootstrap/"))

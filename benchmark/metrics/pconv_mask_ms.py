"""ms: device time a video of the operations launched in the program's
span ``kbe/bootstrap/pconv_mask``: the partial convs' mask side (coverage,
ratio, bias, re-mask) in both inpainting nets of both bootstrap steps, from
the program slice (``benchmark/program.py``). None where the nets have no
partial convs, or the program no such span."""


def value(record):
    prog = record.get("program") or {}
    row = (prog.get("spans") or {}).get("bootstrap/pconv_mask") or {}
    return row.get("device_ms") or None

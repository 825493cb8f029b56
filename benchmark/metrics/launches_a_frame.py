"""launches: the device operations (kernels, copies, fills) that start
inside ``fn.render_frames`` in the profiled slice, from ``torch.profiler``,
over its frames."""


def value(record):
    prof = record.get("profile")
    if not prof or not prof.get("frames") or not prof.get("loop_launches"):
        return None
    return prof["loop_launches"] / prof["frames"]

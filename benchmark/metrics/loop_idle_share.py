"""%: the share of the program's ``kbe/pose_loop`` spans' host time in which
no device operation ran, from the program slice (``benchmark/program.py``):
one less the union of the device intervals clipped to each span, on the
profiler's one clock, over the loop's host time on the same requests with
tracing on and no profiler (the profiler about doubles the loop's host
time and leaves its device time as it is)."""


def value(record):
    prog = record.get("program") or {}
    if not prog.get("device_ms") or not prog.get("loop_ms"):
        return None
    return 100.0 * (1.0 - prog["loop_busy_ms"] / prog["loop_ms"])

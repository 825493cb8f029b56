"""GB/s: the frames' bytes copied to the host (the program's counter
``bytes_to_host``) over the device time of the operations launched in its
span ``kbe/to_host`` (``.cpu().numpy()``: the copies), from the program
slice (``benchmark/program.py``)."""


def value(record):
    prog = record.get("program") or {}
    copied = (prog.get("counters") or {}).get("bytes_to_host")
    ms = (prog.get("spans") or {}).get("to_host", {}).get("device_ms")
    if not copied or not ms:
        return None
    return copied / (ms / 1e3) / 1e9

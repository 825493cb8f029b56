"""s: from the process's start to the first timed request: imports, the
card, the kernels' build (served from the program's build directory after
the first run), the weights, and one warm-up video for each shape of the
mix, of a photograph the window never sends."""


def value(record):
    return record["setup_s"]

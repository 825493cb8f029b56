#!/usr/bin/env python3
"""Count the SASS instructions of kbe_torch's CUDA kernels, by kind.

    python tools/sass_counts.py [--tree DIR ...] [--sources splat,nms]
        [--kernels splat_grad,nms_kernel]

For each tree (default: this checkout), compiles ``kbe_torch/ops/csrc/
<source>.cu`` with the flags of that tree's ``kbe_torch/ops/_build.py``
into a cubin for ``sm_90a``, prints ``nvcc -Xptxas -v``'s lines of the
kernels named (registers, shared memory, spills), and, from ``cuobjdump
-sass``, each such kernel's static instruction count by kind: MUFU (the
special-function unit: reciprocals, the IEEE division's first step), FP32
(FFMA, FMUL, FADD, FSETP, FMNMX, FCHK), loads and stores to shared and
global memory, barriers, shuffles and votes, branches, and the rest.
Static counts: a loop's body counts once. Needs the CUDA toolkit (nvcc,
cuobjdump); builds under a temporary directory. Prints one JSON line a
tree.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KINDS = (("mufu", ("MUFU",)),
         ("fp32", ("FFMA", "FMUL", "FADD", "FSETP", "FMNMX", "FCHK", "FSEL",
                   "FRND")),
         ("shared", ("LDS", "STS", "LDSM")),
         ("global", ("LDG", "STG", "LD.", "ST.", "ATOM", "RED")),
         ("barrier", ("BAR", "SYNCS", "UCGABAR", "MEMBAR")),
         ("warp", ("SHFL", "VOTE", "REDUX", "MATCH")),
         ("branch", ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT",
                     "WARPSYNC")))


# "/*0070*/  @!P0 FFMA R3, R2, R5, R4 ;": the address, a predicate, the op
INSTRUCTION = re.compile(
    r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def kind_of(op: str) -> str:
    for kind, prefixes in KINDS:
        if any(op.startswith(p) for p in prefixes):
            return kind
    return "other"


def toolkit(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        name)
    if not os.path.exists(path):
        raise SystemExit(f"sass_counts: {name} not found")
    return path


def build_flags(tree: str):
    spec = importlib.util.spec_from_file_location(
        "build_of_tree", os.path.join(tree, "kbe_torch", "ops", "_build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    common = [f for f in build._COMMON_FLAGS
              if f not in ("-shared", "-Xcompiler", "-fPIC")]
    return common, {n: flags for n, (flags, _) in build.SOURCES.items()}


def counts_of(sass: str, kernels):
    """{kernel: {kind: n}} from cuobjdump -sass output."""
    out, current = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = next((k for k in kernels if k in m.group(1)), None)
            if current:
                out[current] = collections.Counter()
            continue
        m = INSTRUCTION.match(line)
        if current and m:
            out[current][kind_of(m.group(1))] += 1
            out[current]["total"] += 1
    return {k: dict(v) for k, v in out.items()}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", action="append")
    parser.add_argument("--sources", default="splat,nms")
    parser.add_argument("--kernels", default="splat_grad,nms_kernel")
    args = parser.parse_args()
    kernels = args.kernels.split(",")
    nvcc, cuobjdump = toolkit("nvcc"), toolkit("cuobjdump")
    for tree in [os.path.abspath(t) for t in (args.tree or [HERE])]:
        common, flags = build_flags(tree)
        result = {"tree": tree, "ptxas": [], "sass": {}}
        with tempfile.TemporaryDirectory() as tmp:
            for name in args.sources.split(","):
                cubin = os.path.join(tmp, f"{name}.cubin")
                src = os.path.join(tree, "kbe_torch", "ops", "csrc",
                                   f"{name}.cu")
                done = subprocess.run(
                    [nvcc] + common + flags[name] + ["-cubin", "-o", cubin,
                                                     src],
                    capture_output=True, text=True)
                if done.returncode != 0:
                    print(done.stdout + done.stderr, file=sys.stderr)
                    return 1
                log = (done.stdout + done.stderr).splitlines()
                for i, line in enumerate(log):
                    if "Compiling entry function" in line and any(
                            k in line for k in kernels):
                        result["ptxas"] += [s.strip() for s in log[i:i + 4]]
                sass = subprocess.run([cuobjdump, "-sass", cubin],
                                      capture_output=True, text=True,
                                      check=True).stdout
                result["sass"].update(counts_of(sass, kernels))
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

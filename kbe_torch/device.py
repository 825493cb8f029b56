"""Device selection for the port's entry points."""

from __future__ import annotations

import os
import subprocess

import torch

# the workspace sizes with which cuBLAS is deterministic
CUBLAS_DETERMINISTIC = (":4096:8", ":16:8")


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Asking for CUDA where there is no GPU raises:
    the entry points never fall back to the CPU on their own; pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kbe_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def disable_tf32() -> None:
    """Turn off TF32 for cuDNN convolutions and cuBLAS matmuls.

    cuDNN runs f32 convolutions in TF32 by default; the depth nets move every
    splat, so they must run true f32 (bf16 depth cut mean SSIM from 0.9961
    to 0.9860 in the JAX package's own measurement)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def deterministic_training(on: bool = True) -> None:
    """Make training on the card reproducible (``on``), or free it again.

    ``torch.use_deterministic_algorithms`` holds cuDNN to its deterministic
    convolutions (its fastest f32 backward ones add in an order that varies
    run to run) and gives the nets' bilinear upsampling a deterministic
    backward (an ``index_select``, whose gradient is an ``index_add_`` with
    float atomics otherwise); an op with no deterministic path raises. cuBLAS
    then needs a fixed workspace, ``CUBLAS_WORKSPACE_CONFIG``, before its
    first call: this sets it where CUDA has not started yet and raises where
    it started without it. With this on, two training runs from one seed
    give equal bits, as the splat's kernels do. The mode is global to the
    process, so it is set where training starts (the training CLI), not by
    the trainers."""
    if on:
        conf = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        if conf is None and not torch.cuda.is_initialized():
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = conf = ":4096:8"
        if conf not in CUBLAS_DETERMINISTIC:
            raise RuntimeError(
                "deterministic cuBLAS needs CUBLAS_WORKSPACE_CONFIG set to "
                f"one of {CUBLAS_DETERMINISTIC} before CUDA starts "
                f"(it is {conf!r})")
    torch.use_deterministic_algorithms(on)


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the card, or what it said
    when it failed."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi failed: {err}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"

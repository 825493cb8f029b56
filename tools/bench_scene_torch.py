"""The bench scene of the port's measurement tools: the counterpart of
``tools/bench_scene.py``.

``bench_scene`` builds what the effect sees on the bench: the nets, from
``find_bench_weights()``'s pipeline checkpoint
(``tools/make_bench_weights_torch.py``) through ``load_pipeline_params``,
else seeded random full-width weights (``weights`` says which); the
procedural demo scene; a precision mix of ``MIXES``, the production one
(f32 depth nets, bf16 inpainting nets) unless asked for another;
``build_effect_fn`` of the effect; and its front-end state.
``fidelity_report_torch``, ``profile_frontend_torch``,
``profile_frame_torch`` and ``dtype_sweep_torch`` build their scene here.

``timeit`` gives a call's host ms, the minimum of N runs each ended by
``torch.cuda.synchronize`` on the card; ``device_profile`` its device ms
and launches from ``torch.profiler``. Run the tools with a host that is
otherwise idle: the profiler slows the host, so host ms come from runs
with no profiler.
"""

from __future__ import annotations

import collections
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from kbe_torch.config import CameraConfig, EffectConfig, \
    ZoomSettings  # noqa: E402
from kbe_torch.data import demo_scene_image  # noqa: E402
from kbe_torch.device import card_name, resolve_device  # noqa: E402
from kbe_torch.ops import discfill, finish, nms, splat  # noqa: E402
from kbe_torch.pipeline.kenburns import build_effect_fn, \
    create_models  # noqa: E402
from kbe_torch.train.checkpoint import find_bench_weights, \
    load_pipeline_params  # noqa: E402

# name: (inpainting nets' dtype, depth nets' dtype)
MIXES = {"all_bf16": (torch.bfloat16, torch.bfloat16),
         "depth_f32": (torch.bfloat16, torch.float32),
         "all_f32": (torch.float32, torch.float32)}
PRODUCTION = "depth_f32"
# the hand-written kernels' names on the device timeline
KERNEL_NAMES = ("splat_", "discfill", "nms_kernel", "finish_kernel")


def load_models(checkpoint, device, mix: str = PRODUCTION, seed: int = 0):
    """The effect's nets in the precision ``mix``: the checkpoint's, or
    seeded random ones when ``checkpoint`` is None."""
    dtype, depth_dtype = MIXES[mix]
    if checkpoint:
        return load_pipeline_params(checkpoint, device, dtype, depth_dtype)
    return create_models(seed, device, dtype, depth_dtype)


def weights_of(checkpoint) -> str:
    if checkpoint:
        return (f"the recipe's weights ({os.path.basename(checkpoint)}, "
                "tools/make_bench_weights_torch.py)")
    return "seeded random weights (seed 0; no bench checkpoint)"


def bench_scene(size: int = 1024, steps: int = 75, checkpoint="find",
                mix: str = PRODUCTION, effect=None, device=None,
                front: bool = True) -> dict:
    """The scene as a dict: ``device``, ``size``, ``checkpoint`` (None for
    random weights), ``weights`` (which), ``mix``, ``camera``, ``zoom``,
    ``effect`` (default ``EffectConfig(num_steps=steps)``), ``image``
    (1, H, W, 3) on the device, ``models`` in ``mix``, ``fn``
    (``build_effect_fn``'s) and, with ``front``, ``state``
    (``fn.front_end``'s). ``checkpoint``: a
    pipeline ``.tar``, None, or 'find' for ``find_bench_weights()``.
    ``device`` defaults to ``cuda`` (raises where there is none)."""
    dev = resolve_device(device)
    if checkpoint == "find":
        checkpoint = find_bench_weights()
    effect = EffectConfig(num_steps=steps) if effect is None else effect
    zoom = (ZoomSettings.default_dolly(size, size) if effect.dolly
            else ZoomSettings.default_3d(size, size))
    camera = CameraConfig()
    scene = {
        "device": dev, "size": size, "checkpoint": checkpoint,
        "weights": weights_of(checkpoint), "mix": mix, "camera": camera,
        "zoom": zoom, "effect": effect,
        "image": torch.as_tensor(demo_scene_image(size, size),
                                 device=dev)[None],
        "models": load_models(checkpoint, dev, mix),
        "fn": build_effect_fn(size, size, zoom, camera, effect, device=dev),
    }
    if front:
        scene["state"] = scene["fn"].front_end(scene["models"],
                                               scene["image"])
    return scene


def card_of(dev: torch.device) -> dict:
    """The device's names, as the tools' JSON records them."""
    on_card = dev.type == "cuda"
    return {"device": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "nvidia_smi": card_name() if on_card else None}


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit(fn, dev: torch.device, reps: int = 5,
           warmup: bool = True) -> float:
    """The host ms of ``fn()``: the minimum of ``reps`` runs, each ended by
    a synchronise, after a warm-up run."""
    if warmup:
        fn()
        synchronize(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        synchronize(dev)
        times.append(time.perf_counter() - t0)
    return min(times) * 1e3


def kernel_launches(fn) -> dict:
    """The hand-written kernels that one call of ``fn`` launches, as the
    wrappers count them (``splat.LAUNCHES``, ``discfill.LAUNCHES``,
    ``nms.LAUNCHES``, ``finish.LAUNCHES``); empty on the CPU."""
    counters = (splat.LAUNCHES, discfill.LAUNCHES, nms.LAUNCHES,
                finish.LAUNCHES)
    before = [collections.Counter(c) for c in counters]
    fn()
    counts = {}
    for c, b in zip(counters, before):
        counts.update({k: v - b[k] for k, v in c.items() if v != b[k]})
    return counts


def device_profile(fn, dev: torch.device, calls: int = 2):
    """(device ms, launches) of one call of ``fn`` on the card: the summed
    device intervals of what it runs there (kernels and copies) and their
    number, from ``torch.profiler`` over ``calls`` calls, after a warm-up
    step of as many that the profiler drops. A profile can lose a step's
    first kernels, as if its window opened late, or, late in a process
    that has profiled much, all of them: one in which a kernel does not
    come a multiple of ``calls`` times, or the hand-written ones fall short
    of the wrappers' counts, is taken again, four times at most, and then
    left unmeasured: (None, None), as on the CPU."""
    if dev.type != "cuda":
        return None, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    want = sum(kernel_launches(fn).values()) * calls
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                time.sleep(0.05)
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize(dev)
                prof.step()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep")]
        names = collections.Counter(e.name for e in events)
        own = sum(n for name, n in names.items()
                  if any(k in name for k in KERNEL_NAMES))
        if own >= want and all(n % calls == 0 for n in names.values()):
            return (sum(e.time_range.elapsed_us() for e in events) / 1e3
                    / calls, len(events) // calls)
    print(f"device_profile: five profiles lost kernels ({own} hand-written "
          f"of {want}, counts {dict(names)}); not measured", file=sys.stderr)
    return None, None


def total(values):
    """The sum of ``values``, or None where one is None (not measured)."""
    values = list(values)
    return None if any(v is None for v in values) else sum(values)

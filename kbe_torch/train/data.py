"""Data input pipeline. A numpy copy of ``kbe_tpu/train/data.py``: the
port imports nothing of the JAX package, and this module is host-side
numpy either way.

The reference's torch Dataset, re-designed for the host: multi-dataset
configs with per-name depth decoders ('mega' -> HDF5 /depth with
inf-masking, 'gta' -> EXR with inf clamping, else a 32-bit depth image), a
random 756x1024 crop, an aspect-preserving resize to max_dim, the
mode-dependent downscale ratios (disparity {img/2, disp/4}, refine/eval
{1, 1}, inpainting {2, 2}), [-1, 1] images, and random zoom windows for
inpainting. Batches are numpy dicts; ``Prefetcher`` overlaps their making
with the device's work in a background thread. ``synthetic_batches`` makes
procedural RGBD batches (planes and boxes) from a seed, the same draws as
the JAX package's, for tests, demos and runs with no dataset.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from kbe_torch.config import CameraConfig

CROP_H, CROP_W = 756, 1024  # utils/data_loader.py:26-27

MODE_RATIOS = {
    # utils/data_loader.py:138-143
    "disparity": {"image": 2, "disparity": 4, "masks": 4},
    "refine": {"image": 1, "disparity": 1, "masks": 1},
    "eval": {"image": 1, "disparity": 1, "masks": 1},
    "inpaint-eval": {"image": 1, "disparity": 1, "masks": 1},
    "inpainting": {"image": 2, "disparity": 2, "masks": 2},
}


def get_random_zoom(rng: np.random.Generator, height: int,
                    width: int) -> Dict[str, float]:
    """Random start/end crop windows for simulated 3D KBE moves
    (reference utils/utils.py:341-368)."""
    cu_f = rng.uniform(0.3, 0.7) * width
    cv_f = rng.uniform(0.3, 0.7) * height
    ru = rng.uniform(0.6, 2 / width * min(width - cu_f, cu_f))
    rv = rng.uniform(0.6, 2 / height * min(height - cv_f, cv_f))
    r_from = min(ru, rv)

    cu_t = rng.uniform(max(0.3, cu_f / width * 0.85),
                       min(0.7, cu_f / width * 1.15)) * width
    cv_t = rng.uniform(max(0.3, cv_f / height * 0.85),
                       min(0.7, cv_f / height * 1.15)) * height
    ru = rng.uniform(0.6, 2 / width * min(width - cu_t, cu_t))
    rv = rng.uniform(0.6, 2 / height * min(height - cv_t, cv_t))
    r_to = min(ru, rv)

    return {
        "from_cu": float(int(cu_f)), "from_cv": float(int(cv_f)),
        "from_cw": float(int(width * r_from)),
        "from_ch": float(int(height * r_from)),
        "to_cu": float(int(cu_t)), "to_cv": float(int(cv_t)),
        "to_cw": float(int(width * r_to)),
        "to_ch": float(int(height * r_to)),
    }


def _decode_depth(path: str, name: str, focal: float, baseline: float):
    """Per-dataset depth decoding (utils/data_loader.py:99-114).
    Returns (depth, disparity, mask)."""
    if name == "mega":
        import h5py

        with h5py.File(path, "r") as f:
            depth = np.array(f.get("/depth"), np.float32)
        mask = (depth != 0).astype(np.float32)
        depth = np.where(mask == 0, np.inf, depth)
    else:
        import cv2

        depth = cv2.imread(path, -1)
        if depth is None:
            raise FileNotFoundError(path)
        depth = np.asarray(depth, np.float32)
        if depth.ndim == 3:
            depth = depth[..., 0]
        if name == "gta":
            depth = np.where(np.isinf(depth), focal * baseline, depth)
        mask = np.ones_like(depth, np.float32)
    disparity = focal * baseline / (depth + 1e-4)
    return depth, disparity, mask


def _resize_area(img, w, h):
    import cv2

    return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)


class KBEDataset:
    """File-backed dataset over the reference's directory layout:
    <path>/images/*.png + <path>/depth(s)/* with matching stems."""

    def __init__(self, datasets: Sequence[Dict], max_dim: int = 1024,
                 mode: str = "disparity", seed: int = 42,
                 imagenet_path: Optional[str] = None,
                 mask_source=None, max_instances: int = 8):
        """``mask_source`` feeds the depth mask loss ('same'/'other'
        modes): 'depth' (segment GT disparity, instance_masks_from_depth),
        'image' (color segmentation, instance_masks_from_image), a
        callable ``(image01, disparity|None) -> (M, h, w, 1)``, or None
        (no instance masks — the mask loss is off)."""
        self.datasets = list(datasets)
        self.max_dim = max_dim
        self.mode = mode
        self.mask_source = mask_source
        self.max_instances = max_instances
        self.rng = np.random.default_rng(seed)
        self.items: List[Tuple[str, str, int]] = []
        for ds_id, ds in enumerate(self.datasets):
            root = ds["path"]
            img_dir = os.path.join(root, "images")
            for img in sorted(os.listdir(img_dir)):
                stem = os.path.splitext(img)[0]
                if ds["name"] == "mega":
                    dp = os.path.join(root, "depth", stem + ".h5")
                elif ds["name"] == "gta":
                    dp = os.path.join(root, "depths", stem + ".exr")
                else:
                    dp = os.path.join(root, "depth", img)
                self.items.append((os.path.join(img_dir, img), dp, ds_id))
        self.imagenet_paths: List[str] = []
        if imagenet_path is not None:
            for sub in sorted(os.listdir(imagenet_path)):
                subdir = os.path.join(imagenet_path, sub)
                if os.path.isdir(subdir):
                    for f in sorted(os.listdir(subdir)):
                        self.imagenet_paths.append(os.path.join(subdir, f))

    def __len__(self):
        return len(self.items)

    def split(self, train_frac: float = 0.99, seed: int = 111):
        """99/1 random split (training/train_depth.py:31-35)."""
        perm = np.random.default_rng(seed).permutation(len(self.items))
        n_train = int(train_frac * len(self.items))
        return perm[:n_train], perm[n_train:]

    def load_item(self, index: int) -> Dict[str, np.ndarray]:
        import cv2

        img_path, depth_path, ds_id = self.items[index]
        ds = self.datasets[ds_id]
        focal = ds["params"]["focal"]
        baseline = ds["params"]["baseline"]

        image = cv2.imread(img_path, cv2.IMREAD_COLOR)
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        depth, disparity, mask = _decode_depth(depth_path, ds["name"], focal,
                                               baseline)

        # random 756x1024 crop (utils/data_loader.py:117-124)
        h, w = image.shape[:2]
        if h >= CROP_H and w >= CROP_W:
            sh = self.rng.integers(0, h - CROP_H + 1)
            sw = self.rng.integers(0, w - CROP_W + 1)
            image = image[sh:sh + CROP_H, sw:sw + CROP_W]
            depth = depth[sh:sh + CROP_H, sw:sw + CROP_W]
            disparity = disparity[sh:sh + CROP_H, sw:sw + CROP_W]
            mask = mask[sh:sh + CROP_H, sw:sw + CROP_W]

        # aspect-preserving resize to max_dim, then mode ratios
        h, w = image.shape[:2]
        ratio = w / h
        tw = min(int(self.max_dim * ratio), self.max_dim)
        th = min(int(self.max_dim / ratio), self.max_dim)
        r = MODE_RATIOS[self.mode]
        image = _resize_area(image, tw // r["image"], th // r["image"])
        depth = _resize_area(depth, tw // r["disparity"],
                             th // r["disparity"])
        disparity = _resize_area(disparity, tw // r["disparity"],
                                 th // r["disparity"])
        mask = np.clip(_resize_area(mask, tw // r["masks"],
                                    th // r["masks"]), 0, 1)

        image = image.astype(np.float32) / 255.0 * 2.0 - 1.0  # [-1, 1]
        item = {
            "image": image,
            "disparity": disparity[..., None].astype(np.float32),
            "depth": depth[..., None].astype(np.float32),
            "mask": mask[..., None].astype(np.float32),
            "dataset_id": np.int32(ds_id),
        }
        if self.mode in ("inpainting", "inpaint-eval"):
            dh, dw = disparity.shape[:2]
            item["zoom"] = get_random_zoom(self.rng, dh, dw)
        if self.mask_source is not None and self.mode == "disparity":
            dsp = item["disparity"][..., 0]
            dh2, dw2 = dsp.shape
            img01 = _resize_area((image + 1.0) / 2.0, dw2, dh2)
            item["instance_masks"] = self._masks_for(img01, dsp)
        return item

    def _masks_for(self, image01, disparity):
        if callable(self.mask_source):
            return self.mask_source(image01, disparity)
        if self.mask_source == "depth" and disparity is not None:
            return instance_masks_from_depth(
                disparity, max_instances=self.max_instances)
        return instance_masks_from_image(
            image01, max_instances=self.max_instances)

    def load_imagenet_batch(self, batch_size: int,
                            size: Tuple[int, int]) -> Optional[Dict]:
        """Auxiliary natural-image batch for the 'other' mask-loss mode:
        the reference bundles a random ImageNet image per item and runs
        Mask-RCNN on it (utils/data_loader.py:162-173,
        training/train_depth.py:261-288); here the masks come from
        ``mask_source`` ('image' or a callable)."""
        import cv2

        if not self.imagenet_paths or self.mask_source is None:
            return None
        h, w = size
        imgs, masks = [], []
        for _ in range(batch_size):
            path = self.imagenet_paths[
                int(self.rng.integers(len(self.imagenet_paths)))]
            im = cv2.imread(path, cv2.IMREAD_COLOR)
            im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
            im = cv2.resize(im, (w, h), interpolation=cv2.INTER_AREA)
            im01 = im.astype(np.float32) / 255.0
            imgs.append(im01 * 2.0 - 1.0)
            masks.append(self._masks_for(im01, None))
        return {"image": np.stack(imgs),
                "instance_masks": np.stack(masks)}

    def batches(self, indices, batch_size: int, shuffle: bool = True,
                epochs: Optional[int] = None,
                drop_remainder: bool = True) -> Iterator[Dict]:
        epoch = 0
        indices = np.asarray(indices)
        while epochs is None or epoch < epochs:
            order = (self.rng.permutation(indices) if shuffle else indices)
            for i in range(0, len(order) - batch_size + 1, batch_size):
                items = [self.load_item(j) for j in order[i:i + batch_size]]
                batch = _collate(items, self.mode)
                if (self.imagenet_paths and self.mask_source is not None
                        and self.mode == "disparity"):
                    h, w = batch["disparity"].shape[1:3]
                    batch["imagenet"] = self.load_imagenet_batch(
                        batch_size, (h, w))
                yield batch
            epoch += 1


def _collate(items: List[Dict], mode: str) -> Dict:
    out: Dict[str, Any] = {}
    for key in ("image", "disparity", "depth", "mask"):
        out[key] = np.stack([it[key] for it in items])
    if "instance_masks" in items[0]:
        out["instance_masks"] = np.stack(
            [it["instance_masks"] for it in items])
    if mode in ("inpainting", "inpaint-eval"):
        zoom_keys = items[0]["zoom"].keys()
        out["zoom"] = {k: np.asarray([it["zoom"][k] for it in items],
                                     np.float32) for k in zoom_keys}
    return out


def instance_masks_from_depth(disparity: np.ndarray,
                              max_instances: int = 8,
                              rel_grad_threshold: float = 0.04,
                              min_area_frac: float = 0.004) -> np.ndarray:
    """Host-side instance-mask source for the depth "mask loss".

    The reference obtains object masks from a Mask-RCNN run inside the
    training loop (training/train_depth.py:55,151-163); torchvision (and
    its pretrained weights) is unavailable offline, so the default
    source segments the GT disparity itself: threshold the
    gradient magnitude and take connected components — regions bounded by
    depth discontinuities, which is exactly the "disparity is flat inside
    an object" prior the loss encodes (utils/losses.py:56-68).

    ``disparity``: (h, w). Returns (max_instances, h, w, 1) zero-padded
    float32 masks, largest regions first (the full-frame background
    region is skipped).
    """
    import cv2

    d = disparity.astype(np.float32)
    scale = max(float(np.ptp(d)), 1e-6)
    gy, gx = np.gradient(d / scale)
    flat = (np.hypot(gy, gx) < rel_grad_threshold).astype(np.uint8)
    n, labels, stats, _ = cv2.connectedComponentsWithStats(flat, 8)
    h, w = d.shape
    areas = [(stats[i, cv2.CC_STAT_AREA], i) for i in range(1, n)]
    areas.sort(reverse=True)
    masks = np.zeros((max_instances, h, w, 1), np.float32)
    out = 0
    for area, i in areas:
        if out >= max_instances or area < min_area_frac * h * w:
            break
        if area > 0.8 * h * w:  # background plane, not an object
            continue
        masks[out, ..., 0] = labels == i
        out += 1
    return masks


def instance_masks_from_image(image01: np.ndarray,
                              max_instances: int = 8,
                              k: int = 6,
                              min_area_frac: float = 0.01) -> np.ndarray:
    """Unsupervised segmenter for the 'other'-mode auxiliary natural
    images (no depth available): k-means color clustering + connected
    components. Substitutes the reference's Mask-RCNN on the ImageNet
    batch (training/train_depth.py:261-288); any better segmenter can be
    plugged through KBEDataset(mask_source=callable).

    ``image01``: (h, w, 3) float [0, 1]. Returns
    (max_instances, h, w, 1) float32 masks.
    """
    import cv2

    h, w = image01.shape[:2]
    small = cv2.resize(image01, (min(w, 256), min(h, 192)),
                       interpolation=cv2.INTER_AREA)
    data = small.reshape(-1, 3).astype(np.float32)
    _, labels, _ = cv2.kmeans(
        data, k, None,
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 10, 1.0), 2,
        cv2.KMEANS_PP_CENTERS)
    lab = labels.reshape(small.shape[:2]).astype(np.uint8)
    masks = np.zeros((max_instances, h, w, 1), np.float32)
    regions = []
    for c in range(k):
        n, comp, stats, _ = cv2.connectedComponentsWithStats(
            (lab == c).astype(np.uint8), 8)
        for i in range(1, n):
            regions.append((stats[i, cv2.CC_STAT_AREA], c, i, comp))
    regions.sort(key=lambda r: -r[0])
    out = 0
    sh, sw = lab.shape
    for area, _, i, comp in regions:
        if out >= max_instances or area < min_area_frac * sh * sw:
            break
        m = (comp == i).astype(np.float32)
        masks[out, ..., 0] = cv2.resize(m, (w, h),
                                        interpolation=cv2.INTER_NEAREST)
        out += 1
    return masks


def synthetic_batches(batch_size: int, height: int, width: int,
                      mode: str = "disparity",
                      camera: CameraConfig = CameraConfig(512.0, 74.0),
                      seed: int = 0,
                      steps: Optional[int] = None,
                      with_instance_masks: bool = False,
                      max_instances: int = 4) -> Iterator[Dict]:
    """Procedural RGBD batches (planes + boxes) for tests, demos and
    benchmarks — the environment ships no DIML/GTA/MegaDepth data.
    ``with_instance_masks`` adds the generator's true per-box masks
    (the mask-loss source the reference gets from Mask-RCNN)."""
    rng = np.random.default_rng(seed)
    n = 0
    while steps is None or n < steps:
        imgs, disps, inst = [], [], []
        for _ in range(batch_size):
            depth = np.full((height, width), rng.uniform(30, 90), np.float32)
            img = rng.uniform(0, 1, 3).astype(np.float32) * np.ones(
                (height, width, 3), np.float32)
            item_masks = np.zeros((max_instances, height, width, 1),
                                  np.float32)
            for b in range(rng.integers(1, 4)):
                bh = rng.integers(height // 6, height // 2)
                bw = rng.integers(width // 6, width // 2)
                y = rng.integers(0, height - bh)
                x = rng.integers(0, width - bw)
                d = rng.uniform(10, 40)
                depth[y:y + bh, x:x + bw] = d
                img[y:y + bh, x:x + bw] = rng.uniform(0, 1, 3)
                if b < max_instances:
                    item_masks[b, y:y + bh, x:x + bw, 0] = 1.0
            disp = camera.focal * camera.baseline / (depth + 1e-4)
            imgs.append(img * 2.0 - 1.0)
            disps.append(disp)
            inst.append(item_masks)
        disparity = np.stack(disps)[..., None]
        inst_np = np.stack(inst)
        if mode == "disparity":
            # the estimation net outputs at 1/2 input resolution; real
            # datasets load disparity at half the image size
            # (MODE_RATIOS / utils/data_loader.py:138-143)
            disparity = disparity[:, ::2, ::2]
            inst_np = inst_np[:, :, ::2, ::2]
        batch = {
            "image": np.stack(imgs),
            "disparity": disparity,
            "depth": camera.focal * camera.baseline / (disparity + 1e-7),
            "mask": np.ones_like(disparity),
        }
        if with_instance_masks:
            batch["instance_masks"] = inst_np
            # the 'other'-mode auxiliary batch reuses the same procedural
            # images (stand-in for the reference's ImageNet images)
            batch["imagenet"] = {
                "image": batch["image"].copy(),
                "instance_masks": inst_np,
            }
        if mode == "inpainting":
            zs = [get_random_zoom(rng, height, width)
                  for _ in range(batch_size)]
            batch["zoom"] = {k: np.asarray([z[k] for z in zs], np.float32)
                             for k in zs[0]}
        n += 1
        yield batch


class Prefetcher:
    """Background-thread batch prefetcher (replaces torch DataLoader
    workers, utils/data_loader.py:199-201)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()

        def worker():
            try:
                for item in it:
                    self.q.put(item)
            finally:
                self.q.put(self._done)

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._done:
                return
            yield item

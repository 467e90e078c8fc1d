"""Dataset preparation: an image folder (or the CIFAR-10 python batches) ->
TFRecord shards (a copy of `dcgan_tpu/data/prepare.py`).

    python -m dcgan_tpu_torch.data.prepare --input_dir photos/ \
        --output_dir train/
    python -m dcgan_tpu_torch.data.prepare --input_dir cifar/ \
        --output_dir recs/ --labeled --image_size 32 --crop_size 0
    python -m dcgan_tpu_torch.data.prepare --cifar10 \
        --input_dir cifar-10-batches-py/ --output_dir recs/

Each image is center-cropped to `crop_size`, resized to `image_size` and
written as one `tf.train.Example` with the bytes feature `image_raw` (the
pixels in [0, 255] as `record_dtype`, uint8 by default, 8 times smaller
than float64) and, with --labeled, the int64 `label` of its class
subdirectory (sorted order). The examples are shuffled (seeded) into
`num_shards` shards `shard-NNNNN.tfrecord`, beside a `dataset.json`
manifest that `data/pipeline.py::check_manifest` holds the DataConfig
against and whose record_dtype the trainer adopts. An output directory
that already holds shards is refused unless --overwrite. The files are
byte for byte the JAX package's, so either package's shards load in
either package's loaders.

PIL is imported inside `load_and_preprocess` (and for a resized CIFAR),
never at import.
"""

from __future__ import annotations

import argparse
import json
import os
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dcgan_tpu_torch.data.example_proto import serialize_example
from dcgan_tpu_torch.data.pipeline import MANIFEST_NAME
from dcgan_tpu_torch.data.tfrecord import write_tfrecords

_IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


def list_images(input_dir: str, labeled: bool
                ) -> Tuple[List[Tuple[str, int]], List[str]]:
    """[(path, label)], [class names]. Unlabeled: label is always 0."""
    if labeled:
        classes = sorted(
            d for d in os.listdir(input_dir)
            if os.path.isdir(os.path.join(input_dir, d)))
        if not classes:
            raise ValueError(f"--labeled needs class subdirectories under "
                             f"{input_dir}")
        pairs = []
        for idx, cls in enumerate(classes):
            cdir = os.path.join(input_dir, cls)
            for name in sorted(os.listdir(cdir)):
                if os.path.splitext(name)[1].lower() in _IMAGE_EXTS:
                    pairs.append((os.path.join(cdir, name), idx))
        return pairs, classes
    pairs = [(os.path.join(input_dir, name), 0)
             for name in sorted(os.listdir(input_dir))
             if os.path.splitext(name)[1].lower() in _IMAGE_EXTS]
    return pairs, []


def load_and_preprocess(path: str, *, image_size: int, crop_size: int,
                        channels: int = 3) -> np.ndarray:
    """Decode -> optional center-crop to crop_size -> resize to image_size.

    Returns [image_size, image_size, channels] float64 in [0, 255].
    """
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB" if channels == 3 else "L")
        if crop_size:
            w, h = im.size
            if min(w, h) < crop_size:
                # upscale the short side first so the crop is always valid
                scale = crop_size / min(w, h)
                im = im.resize((max(crop_size, int(round(w * scale))),
                                max(crop_size, int(round(h * scale)))),
                               Image.BILINEAR)
                w, h = im.size
            left = (w - crop_size) // 2
            top = (h - crop_size) // 2
            im = im.crop((left, top, left + crop_size, top + crop_size))
        if im.size != (image_size, image_size):
            im = im.resize((image_size, image_size), Image.BILINEAR)
        arr = np.asarray(im, dtype=np.float64)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _clear_stale_shards(output_dir: str, overwrite: bool) -> None:
    """Refuse (or, with overwrite, remove) shards from a previous run: the
    pipeline treats every file as a shard, so leftovers would silently mix
    into the dataset."""
    stale = sorted(
        f for f in os.listdir(output_dir)
        if f.startswith("shard-") and f.endswith(".tfrecord"))
    if not stale:
        return
    if not overwrite:
        raise ValueError(
            f"{output_dir} already holds {len(stale)} shard(s); pass "
            "--overwrite to replace them")
    for f in stale:
        os.remove(os.path.join(output_dir, f))
    manifest_path = os.path.join(output_dir, MANIFEST_NAME)
    if os.path.exists(manifest_path):
        os.remove(manifest_path)


def _write_shards(output_dir: str, items: list, record_fn,
                  num_shards: int, manifest: dict) -> List[str]:
    """Split shuffled `items` into contiguous chunks, serialize each via
    `record_fn(item) -> bytes` into shard-NNNNN.tfrecord, and write the
    dataset.json manifest. Shared by every converter so sharding and
    manifest behavior cannot diverge between dataset formats."""
    num_shards = max(1, min(num_shards, len(items)))
    paths: List[str] = []
    bounds = np.linspace(0, len(items), num_shards + 1, dtype=int)
    for s in range(num_shards):
        chunk = items[bounds[s]:bounds[s + 1]]
        shard = os.path.join(output_dir, f"shard-{s:05d}.tfrecord")
        write_tfrecords(shard, (record_fn(item) for item in chunk))
        paths.append(shard)
    with open(os.path.join(output_dir, MANIFEST_NAME), "w") as f:
        json.dump({**manifest, "num_shards": len(paths)}, f, indent=2)
    return paths


def convert(input_dir: str, output_dir: str, *, image_size: int = 64,
            crop_size: int = 108, channels: int = 3, num_shards: int = 8,
            record_dtype: str = "uint8", labeled: bool = False,
            feature_name: str = "image_raw",
            label_feature: str = "label", seed: int = 0,
            overwrite: bool = False) -> List[str]:
    """Convert an image folder to TFRecord shards; returns shard paths.

    Examples are shuffled (seeded) before sharding so shards — and therefore
    per-host shard assignments — are class- and order-balanced. Refuses an
    output_dir that already holds shards unless overwrite=True (stale shards
    from a previous run would otherwise silently mix into the dataset, since
    the pipeline treats every file as a shard). Writes a dataset.json
    manifest (counts, classes, knobs) alongside, which make_dataset
    validates DataConfig against.
    """
    pairs, classes = list_images(input_dir, labeled)
    if not pairs:
        raise ValueError(f"no images found under {input_dir}")
    os.makedirs(output_dir, exist_ok=True)
    _clear_stale_shards(output_dir, overwrite)
    random.Random(seed).shuffle(pairs)

    def record_fn(pair) -> bytes:
        path, label = pair
        arr = load_and_preprocess(path, image_size=image_size,
                                  crop_size=crop_size, channels=channels)
        feats = {feature_name: [arr.astype(record_dtype).tobytes()]}
        if labeled:
            feats[label_feature] = [label]
        return serialize_example(feats)

    return _write_shards(output_dir, pairs, record_fn, num_shards, {
        "num_examples": len(pairs),
        "image_size": image_size,
        "crop_size": crop_size,
        "channels": channels,
        "record_dtype": record_dtype,
        "classes": classes,
        "feature_name": feature_name,
        "label_feature": label_feature if labeled else "",
    })


_CIFAR10_CLASSES = ["airplane", "automobile", "bird", "cat", "deer",
                    "dog", "frog", "horse", "ship", "truck"]


def convert_cifar10(input_dir: str, output_dir: str, *,
                    split: str = "train", image_size: int = 32,
                    num_shards: int = 8, record_dtype: str = "uint8",
                    feature_name: str = "image_raw",
                    label_feature: str = "label", seed: int = 0,
                    overwrite: bool = False) -> List[str]:
    """CIFAR-10 python-version batches -> labeled TFRecord shards.

    Reads the standard `cifar-10-batches-py` pickles (data_batch_1..5 for
    train, test_batch for test): each holds N x 3072 uint8 rows in
    R,G,B-plane order plus a labels list (the JAX package's `cifar10-cond`
    preset trains on them).
    """
    import pickle

    names = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
             else ["test_batch"])
    xs, ys = [], []
    for name in names:
        path = os.path.join(input_dir, name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found — expected the cifar-10-batches-py "
                "layout")
        with open(path, "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(batch[b"data"], dtype=np.uint8))
        ys.extend(int(v) for v in batch[b"labels"])
    # N x 3072 plane-order rows -> NHWC
    images = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)

    os.makedirs(output_dir, exist_ok=True)
    _clear_stale_shards(output_dir, overwrite)
    order = list(range(len(images)))
    random.Random(seed).shuffle(order)

    def record_fn(idx) -> bytes:
        arr = images[idx].astype(np.float64)
        if image_size != 32:
            from PIL import Image

            arr = np.asarray(
                Image.fromarray(images[idx]).resize(
                    (image_size, image_size), Image.BILINEAR),
                dtype=np.float64)
        return serialize_example({
            feature_name: [arr.astype(record_dtype).tobytes()],
            label_feature: [ys[idx]],
        })

    return _write_shards(output_dir, order, record_fn, num_shards, {
        "num_examples": len(order),
        "image_size": image_size,
        "crop_size": 0,
        "channels": 3,
        "record_dtype": record_dtype,
        "classes": _CIFAR10_CLASSES,
        "feature_name": feature_name,
        "label_feature": label_feature,
    })


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dcgan_tpu_torch.data.prepare",
        description="Convert an image folder to the TFRecord schema the "
                    "training pipeline reads.")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--image_size", type=int, default=None,
                   help="output resolution (default 64; 32 with --cifar10)")
    p.add_argument("--crop_size", type=int, default=108,
                   help="center-crop source size before resizing; 0 "
                        "disables")
    p.add_argument("--channels", type=int, default=3)
    p.add_argument("--num_shards", type=int, default=8)
    p.add_argument("--record_dtype", default=None,
                   choices=["float64", "float32", "uint8"],
                   help="on-disk pixel dtype; default uint8 (8x smaller "
                        "than float64, the reference's format)")
    p.add_argument("--labeled", action="store_true",
                   help="class subdirectories -> int64 label feature")
    p.add_argument("--cifar10", action="store_true",
                   help="input_dir is a cifar-10-batches-py directory; "
                        "writes labeled 32x32 records (cifar10-cond preset)")
    p.add_argument("--split", choices=["train", "test"], default="train",
                   help="CIFAR-10 split (with --cifar10)")
    p.add_argument("--seed", type=int, default=0,
                   help="shuffle seed for example-to-shard assignment")
    p.add_argument("--overwrite", action="store_true",
                   help="replace shards already present in output_dir")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.cifar10:
        paths = convert_cifar10(
            args.input_dir, args.output_dir, split=args.split,
            image_size=args.image_size or 32,
            num_shards=args.num_shards,
            record_dtype=args.record_dtype or "uint8",
            seed=args.seed, overwrite=args.overwrite)
    else:
        paths = convert(args.input_dir, args.output_dir,
                        image_size=args.image_size or 64,
                        crop_size=args.crop_size,
                        channels=args.channels, num_shards=args.num_shards,
                        record_dtype=args.record_dtype or "uint8",
                        labeled=args.labeled,
                        seed=args.seed, overwrite=args.overwrite)
    print(f"wrote {len(paths)} shards to {args.output_dir}")


if __name__ == "__main__":
    main()

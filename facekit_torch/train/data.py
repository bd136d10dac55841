"""Training data loader: identity folders -> prefetched batches.

The port's own copy of ``facekit/train/data.py`` (numpy and cv2 only).
Each identity folder ``<root>/<identity>/<image>`` is a class; images
decode on a host thread pool (cv2 releases the GIL) and the next batch is
always in flight while the current one is consumed. The loader makes
facekit's numpy ``Generator`` calls in facekit's order, so one seed gives
both packages the same batches: one ``permutation(n)`` per epoch, drawn
when the epoch's first batch is submitted, and one ``random(len(batch))``
of flips per batch as that batch is submitted, which with double
buffering is before the previous batch is yielded. It yields numpy
arrays; the train step copies them to the device.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


class FolderDataset:
    """Scan <root>/<identity>/<image> into (paths, labels, class_names)."""

    def __init__(self, root: str):
        self.root = root
        self.class_names: List[str] = []
        self.paths: List[str] = []
        self.labels: List[int] = []
        for cname in sorted(os.listdir(root)):
            cdir = os.path.join(root, cname)
            if not os.path.isdir(cdir):
                continue
            imgs = [os.path.join(cdir, f) for f in sorted(os.listdir(cdir))
                    if f.lower().endswith(_IMG_EXTS)]
            if not imgs:
                continue
            label = len(self.class_names)
            self.class_names.append(cname)
            self.paths.extend(imgs)
            self.labels.extend([label] * len(imgs))

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def num_classes(self) -> int:
        return len(self.class_names)


def _load_one(path: str, hw: Tuple[int, int], flip: bool) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    h, w = hw
    if img.shape[:2] != (h, w):
        img = cv2.resize(img, (w, h))
    if flip:
        img = img[:, ::-1]
    # the serving path's preprocessing: BGR->RGB, (x - 127.5) / 128
    # (ops.preprocess.rec_normalize)
    rgb = img[:, :, ::-1].astype(np.float32)
    return (rgb - 127.5) * 0.0078125


def data_loader(dataset: FolderDataset, batch_size: int,
                rec_hw: Tuple[int, int] = (112, 112), shuffle: bool = True,
                seed: int = 0, num_workers: int = 4,
                augment_flip: bool = True, drop_remainder: bool = True,
                num_epochs: Optional[int] = 1,
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (images (B, h, w, 3) f32 normalized, labels (B,) i32).

    Decode runs on ``num_workers`` threads and the NEXT batch is always in
    flight while the current one is consumed (double buffering), so a
    train step never waits on JPEG decode. ``num_epochs=None`` streams
    forever.
    """
    rng = np.random.default_rng(seed)
    n = len(dataset)
    if n == 0:
        return
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=num_workers)
    try:
        def batches_of_indices():
            epoch = 0
            while num_epochs is None or epoch < num_epochs:
                order = (rng.permutation(n) if shuffle
                         else np.arange(n))
                stop = (n - batch_size + 1) if drop_remainder else n
                # drop_remainder promises batches of one size: a dataset
                # smaller than the batch yields nothing rather than a
                # short batch
                for i in range(0, max(stop, 0 if drop_remainder else 1),
                               batch_size):
                    yield order[i:i + batch_size]
                epoch += 1

        def submit(idx: Sequence[int]):
            flips = (rng.random(len(idx)) < 0.5) if augment_flip \
                else np.zeros(len(idx), bool)
            futs = [pool.submit(_load_one, dataset.paths[j], rec_hw,
                                bool(f)) for j, f in zip(idx, flips)]
            labels = np.asarray([dataset.labels[j] for j in idx], np.int32)
            return futs, labels

        it = batches_of_indices()
        pending = None
        for idx in it:
            nxt = submit(idx)
            if pending is not None:
                futs, labels = pending
                yield np.stack([f.result() for f in futs]), labels
            pending = nxt
        if pending is not None:
            futs, labels = pending
            yield np.stack([f.result() for f in futs]), labels
    finally:
        pool.shutdown(wait=False, cancel_futures=True)

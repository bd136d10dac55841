"""facekit_torch's folder loader against facekit's
(``facekit/train/data.py``): for one seed, the same batches and labels,
bit for bit, over two epochs with flips on, with ``drop_remainder`` and
with the short final batch, and when streaming (``num_epochs=None``)."""

import itertools

import cv2
import numpy as np
import pytest

from facekit.train.data import FolderDataset as FkDataset
from facekit.train.data import data_loader as fk_loader
from facekit_torch.train.data import FolderDataset, data_loader


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    rng = np.random.default_rng(162)
    top = tmp_path_factory.mktemp("faces")
    for cname, n in (("ann", 3), ("bo", 4), ("cy", 2)):
        (top / cname).mkdir()
        for i in range(n):
            img = rng.integers(0, 256, size=(24, 20, 3), dtype=np.uint8)
            cv2.imwrite(str(top / cname / f"{i}.png"), img)
    (top / "readme.txt").write_text("not an identity")
    (top / "empty").mkdir()
    return str(top)


def _batches(loader):
    return [(x.copy(), y.copy()) for x, y in loader]


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_batches_equal_facekit(root, drop_remainder):
    ours_ds, ref_ds = FolderDataset(root), FkDataset(root)
    assert ours_ds.class_names == ref_ds.class_names == ["ann", "bo", "cy"]
    assert ours_ds.paths == ref_ds.paths and ours_ds.labels == ref_ds.labels
    kw = dict(batch_size=4, rec_hw=(28, 24), seed=7, num_workers=2,
              augment_flip=True, drop_remainder=drop_remainder,
              num_epochs=2)
    ours = _batches(data_loader(ours_ds, **kw))
    ref = _batches(fk_loader(ref_ds, **kw))
    # 9 images: 2 full batches an epoch, or 2 and a short one of 1
    assert [len(y) for _, y in ours] == (
        [4, 4, 4, 4] if drop_remainder else [4, 4, 1, 4, 4, 1])
    assert len(ours) == len(ref)
    for (x, y), (rx, ry) in zip(ours, ref):
        assert x.dtype == np.float32 and x.shape[1:] == (28, 24, 3)
        assert y.dtype == np.int32
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
    flipped = any(not np.array_equal(x[:, :, ::-1], x) for x, _ in ours)
    assert flipped


def test_streaming_and_small_dataset_equal_facekit(root):
    kw = dict(batch_size=2, rec_hw=(24, 20), seed=3, num_workers=1,
              num_epochs=None)
    ours = list(itertools.islice(data_loader(FolderDataset(root), **kw), 11))
    ref = list(itertools.islice(fk_loader(FkDataset(root), **kw), 11))
    for (x, y), (rx, ry) in zip(ours, ref):
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
    # a dataset smaller than the batch: nothing under drop_remainder
    big = dict(batch_size=16, rec_hw=(24, 20), seed=3, num_workers=1)
    assert list(data_loader(FolderDataset(root), **big)) == []
    short = list(data_loader(FolderDataset(root), drop_remainder=False,
                             **big))
    assert [len(y) for _, y in short] == [9]

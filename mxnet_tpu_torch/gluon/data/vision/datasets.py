"""gluon.data.vision datasets — the port of
``mxnet_tpu/gluon/data/vision/datasets.py``: MNIST, FashionMNIST, CIFAR10,
CIFAR100, ImageRecordDataset, ImageFolderDataset and
DecodedImageRecordDataset.

The downloadable datasets read local files only (idx-ubyte for MNIST, with
or without ``.gz``; the python pickle batches for CIFAR); a missing root
raises, as in the reference.  Samples are NDArrays on the current context
(a DataLoader worker's is the host); images are HxWxC uint8, labels
int32.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from ....base import MXNetError
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset",
           "DecodedImageRecordDataset"]


def _open_maybe_gz(path):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._root = os.path.expanduser(root)
        self._transform = transform
        self._data = None
        self._label = None
        if not os.path.isdir(self._root):
            raise MXNetError(
                f"dataset root {self._root} does not exist; nothing is "
                "downloaded: place the dataset files there")
        self._get_data()

    def __getitem__(self, idx):
        from .... import ndarray as nd
        x = nd.array(self._data[idx])
        y = self._label[idx]
        if self._transform is not None:
            return self._transform(x, y)
        return x, y

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from its idx-ubyte files (``.gz`` too) under ``root``."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        self._train_data = ("train-images-idx3-ubyte",
                            "train-labels-idx1-ubyte")
        self._test_data = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
        super().__init__(root, transform)

    def _get_data(self):
        images, labels = self._train_data if self._train else self._test_data
        with _open_maybe_gz(os.path.join(self._root, labels)) as f:
            struct.unpack(">II", f.read(8))
            self._label = np.frombuffer(f.read(), dtype=np.uint8) \
                .astype(np.int32)
        with _open_maybe_gz(os.path.join(self._root, images)) as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
            self._data = data.reshape(n, rows, cols, 1)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _batches(self):
        if self._train:
            return [f"data_batch_{i}" for i in range(1, 6)]
        return ["test_batch"]

    def _get_data(self):
        # the cifar-10-batches-py layout, or a root holding the batches
        base = self._root
        sub = os.path.join(base, "cifar-10-batches-py")
        if os.path.isdir(sub):
            base = sub
        data, labels = [], []
        for b in self._batches():
            with open(os.path.join(base, b), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            data.append(d[b"data"])
            labels.extend(d[b"labels"])
        data = np.concatenate(data).reshape(-1, 3, 32, 32)
        self._data = data.transpose(0, 2, 3, 1)   # HWC, as the reference
        self._label = np.asarray(labels, dtype=np.int32)


class CIFAR100(_DownloadedDataset):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._train = train
        self._fine = fine_label
        super().__init__(root, transform)

    def _get_data(self):
        base = self._root
        sub = os.path.join(base, "cifar-100-python")
        if os.path.isdir(sub):
            base = sub
        with open(os.path.join(base, "train" if self._train else "test"),
                  "rb") as f:
            d = pickle.load(f, encoding="bytes")
        self._data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        key = b"fine_labels" if self._fine else b"coarse_labels"
        self._label = np.asarray(d[key], dtype=np.int32)


class ImageRecordDataset(Dataset):
    """Images (decoded by ``image.imdecode``) and labels of a RecordIO
    pack."""

    def __init__(self, filename, flag=1, transform=None):
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        from .... import image, recordio
        header, img_bytes = recordio.unpack(self._record[idx])
        img = image.imdecode(img_bytes, self._flag)
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(Dataset):
    """``root/<label name>/<image>`` files; labels by sorted folder."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = {".jpg", ".jpeg", ".png", ".bmp"}
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if os.path.splitext(fname)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from .... import image
        fname, label = self.items[idx]
        img = image.imread(fname, self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class DecodedImageRecordDataset(Dataset):
    """``(CHW float32 image, float32 label)`` samples of a RecordIO pack
    with ImageRecordIter's augmentations, resolved at decode time from a
    seed per index, so that sample ``i`` is the same bytes whoever
    decodes it.  That lets ``DataLoader(num_workers > 0)`` route it
    through the shared-memory decode pool (``io.pipeline``), bit-identical
    to ``num_workers=0``.  ``part_index``/``num_parts`` shard the
    records."""

    def __init__(self, filename, data_shape, path_imgidx=None,
                 rand_crop=False, rand_mirror=False, mean=(0.0, 0.0, 0.0),
                 std=(1.0, 1.0, 1.0), resize=-1, part_index=0, num_parts=1,
                 seed=0):
        from .... import recordio
        idx_path = path_imgidx or os.path.splitext(filename)[0] + ".idx"
        if not os.path.exists(idx_path):
            raise MXNetError(
                f"DecodedImageRecordDataset requires an index file "
                f"({idx_path}); create it with tools/im2rec.py")
        self._rec = recordio.MXIndexedRecordIO(idx_path, filename, "r")
        self._keys = list(self._rec.keys)[part_index::num_parts]
        self._seed = int(seed)
        self._cfg = {
            "rec_path": filename,
            "data_shape": tuple(data_shape),
            "resize": resize,
            "rand_crop": bool(rand_crop),
            "rand_mirror": bool(rand_mirror),
            "mean": np.asarray(mean, np.float32),
            "std": np.asarray(std, np.float32),
        }

    def __len__(self):
        return len(self._keys)

    def set_seed(self, seed):
        """Re-seed the per-index augmentation stream (e.g. per epoch)."""
        self._seed = int(seed)

    def _sample_seed(self, idx):
        from ....io.io import _mix_seed
        return _mix_seed(self._seed, idx)

    def __getitem__(self, idx):
        from ....io.io import _decode_record
        raw = self._rec.read_idx(self._keys[idx])
        return _decode_record(
            raw, self._cfg, np.random.RandomState(self._sample_seed(idx)))

    def _decode_plan(self):
        """The DataLoader's decode-pool protocol: (reader, cfg, keys,
        seed of an index)."""
        return self._rec, self._cfg, self._keys, self._sample_seed

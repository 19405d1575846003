"""gluon.data.vision — the port's transforms and the image datasets
(MNIST, FashionMNIST, CIFAR10/100, ImageRecordDataset, ImageFolderDataset,
DecodedImageRecordDataset)."""

from . import transforms  # noqa: F401
from .datasets import *  # noqa: F401,F403

"""gluon.data.vision — the port's transforms (``transforms``).  The image
datasets (MNIST, CIFAR, ImageRecordDataset, ...) wait for the image-decode
slice."""

from . import transforms  # noqa: F401

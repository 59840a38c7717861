"""Data layer of the port: device-side normalisation and batching."""

from segtpu_torch.data.loader import DeviceDataLoader
from segtpu_torch.data.preprocess import (normalize_canonical,
                                          normalize_microscopy_image,
                                          scale_canonical)

"""Data layer of the port: discovery, decode, resize and normalisation,
device-resident batches, on-device augmentation."""

from segtpu_torch.data.augment import (AUGMENTATION_CANDIDATES,
                                       CellAugmenter, build_pipeline)
from segtpu_torch.data.discovery import load_original_data
from segtpu_torch.data.io import (decode_gray, make_synthetic_dataset,
                                  write_tiff)
from segtpu_torch.data.loader import (CellSegmentationDataset,
                                      DeviceDataLoader, prepare_data)
from segtpu_torch.data.preprocess import (load_canonical,
                                          load_canonical_images,
                                          normalize_canonical,
                                          normalize_microscopy_image,
                                          scale_canonical)

"""Data discovery: pairing ``*_GT.tif`` masks with images (port of
``segtpu/data/discovery.py``, the same code).

The reference's pairing contract (dataset.py:69-118): masks live in
``<data_dir>/GT_masks``, images in ``<data_dir>/Labelled_images``; a mask
``X_GT.tif`` pairs with image ``X.tif``; the modality character ('B'
fluorescent / 'W' broadband) is ``parts[3][1]`` of the underscore-split
filename.
"""

from __future__ import annotations

import os
from typing import Dict, List


def pair_mask_to_image(mask_file: str) -> str:
    """``..._GT.tif`` → ``....tif`` (dataset.py:104)."""
    return mask_file[:-7] + ".tif"


def modality_of(mask_file: str) -> str:
    """Extract 'B'/'W' from the filename (dataset.py:97-98)."""
    parts = mask_file.split("_")
    return parts[3][1]


def base_name_of(mask_file: str) -> str:
    """Base image name for group-aware CV splits
    (forward_selection_integration.py:229-230)."""
    return mask_file[:-7]


def load_original_data(data_dir: str = "manual_labels",
                       image_type: str = "W",
                       with_groups: bool = False) -> Dict:
    """Pair original image/mask TIFFs, filtered by modality.

    Returns ``{'image_paths': [...], 'mask_paths': [...]}`` (plus
    ``'base_names'`` when ``with_groups``), in the masks' sorted order.
    Reference: dataset.py:69-118.
    """
    images_dir = os.path.join(data_dir, "Labelled_images")
    masks_dir = os.path.join(data_dir, "GT_masks")

    if not os.path.exists(images_dir) or not os.path.exists(masks_dir):
        raise FileNotFoundError(f"Data directories not found in {data_dir}")

    all_masks = sorted(os.listdir(masks_dir))
    all_images = set(os.listdir(images_dir))

    image_paths: List[str] = []
    mask_paths: List[str] = []
    base_names: List[str] = []

    for mask_file in all_masks:
        if not mask_file.endswith("GT.tif"):
            continue
        try:
            if modality_of(mask_file) != image_type:
                continue
        except IndexError:
            continue
        original_file = pair_mask_to_image(mask_file)
        if original_file in all_images:
            image_paths.append(os.path.join(images_dir, original_file))
            mask_paths.append(os.path.join(masks_dir, mask_file))
            base_names.append(base_name_of(mask_file))

    print(f"Loaded {len(image_paths)} original {image_type} images")

    out = {"image_paths": image_paths, "mask_paths": mask_paths}
    if with_groups:
        out["base_names"] = base_names
    return out

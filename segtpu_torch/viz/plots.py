"""Visualization trio (port of ``segtpu/viz/plots.py``; reference:
visualize.py:8-135).

matplotlib is imported inside each function only: where it cannot be
imported (the card's machine has none), the function prints ``figure not
drawn: matplotlib is not installed`` and returns None. The prediction of
``visualize_predictions`` runs through the port's model in eval mode on
the model's device: on CUDA that is the serving path, with its kernels.
"""

from __future__ import annotations

import os
from typing import Optional

from segtpu_torch.data.discovery import load_original_data
from segtpu_torch.data.io import decode_gray
from segtpu_torch.data.loader import CellSegmentationDataset
from segtpu_torch.infer.predict import predict_proba


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None (after the line
    saying so) where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print("figure not drawn: matplotlib is not installed")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def visualize_predictions(engine, state, loader, num_samples: int = 3,
                          save_path: Optional[str] = None):
    """Input / ground-truth / prediction grid (visualize.py:8-80).

    ``engine``: a ``TrainEngine`` (API parity; the model is the state's);
    ``state``: a ``TrainState``; ``loader``: a ``DeviceDataLoader``, whose
    first batch is shown. Returns the figure."""
    plt = _pyplot()
    if plt is None:
        return None
    images, masks = next(iter(loader))       # (B, 1, S, S) numpy
    model = state.model
    p = next(model.parameters())
    preds = predict_proba(model, images[:, 0], device=p.device)[..., 0]

    num_samples = min(num_samples, len(images))
    fig, axs = plt.subplots(3, num_samples, figsize=(4 * num_samples, 12),
                            squeeze=False)
    for i in range(num_samples):
        for row, (img, title) in enumerate((
                (images[i, 0], "Input Image"), (masks[i, 0], "Ground Truth"),
                ((preds[i] > 0.5).astype(float), "Prediction"))):
            axs[row, i].imshow(img, cmap="gray")
            axs[row, i].set_title(title)
            axs[row, i].axis("off")
    plt.tight_layout()
    if save_path:
        plt.savefig(save_path, dpi=200, bbox_inches="tight")
        print(f"Visualization saved to {save_path}")
    return fig


def plot_broadband_vs_fluorescence(
        data_dir: str = "manual_labels",
        save_path: str = "figures/image_comparison.pdf"):
    """Side-by-side modality figure (visualize.py:83-103)."""
    plt = _pyplot()
    if plt is None:
        return None
    data_w = load_original_data(data_dir, image_type="W")
    data_b = load_original_data(data_dir, image_type="B")
    img_w = decode_gray(data_w["image_paths"][0])
    img_b = decode_gray(data_b["image_paths"][0])

    fig, axs = plt.subplots(1, 2, figsize=(10, 5))
    axs[0].imshow(img_w, cmap="gray")
    axs[0].set_title("Broadband Image (W)")
    axs[0].axis("off")
    axs[1].imshow(img_b, cmap="gray")
    axs[1].set_title("Fluorescence Image (B)")
    axs[1].axis("off")
    os.makedirs(os.path.dirname(save_path), exist_ok=True)
    plt.tight_layout()
    plt.savefig(save_path, bbox_inches="tight")
    print(f"Saved comparison to {save_path}")
    plt.close(fig)
    return fig


def plot_class_imbalance(image_type: str = "W",
                         data_dir: str = "manual_labels",
                         img_size=(256, 256),
                         save_path: str = "figures/class_imbalance_bar.pdf",
                         *, device="cuda"):
    """Foreground/background pixel share bar chart (visualize.py:105-135);
    the masks are decoded and resized on ``device``. Returns the
    foreground share."""
    plt = _pyplot()
    if plt is None:
        return None
    data = load_original_data(data_dir, image_type=image_type)
    ds = CellSegmentationDataset(data["image_paths"], data["mask_paths"],
                                 img_size=img_size, device=device)
    _, masks = ds.materialize()
    ratio = float(masks.sum() / masks.numel())
    bg = 1 - ratio

    fig, ax = plt.subplots(figsize=(6, 5))
    ax.bar(["Background", "Foreground"], [bg * 100, ratio * 100],
           color=["gray", "red"])
    ax.set_ylabel("Pixel Percentage (%)")
    ax.set_title("Class Imbalance in Cancer Cell Masks")
    ax.set_ylim(0, 100)
    for i, v in enumerate([bg * 100, ratio * 100]):
        ax.text(i, v + 1, f"{v:.2f}%", ha="center")
    os.makedirs(os.path.dirname(save_path), exist_ok=True)
    plt.tight_layout()
    plt.savefig(save_path, dpi=200)
    print(f"Saved imbalance plot to {save_path}")
    plt.close(fig)
    return ratio

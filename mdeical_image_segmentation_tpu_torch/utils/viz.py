"""Dataset visualization (the JAX package's ``utils/viz.py``): ``show``
draws a 2D sample's image and mask side by side, ``show_transform_grid``
the middle slice of a volume under each of a list of transforms.  Both
write a PNG through matplotlib's Agg backend, which is imported inside the
functions: the port's modules import without matplotlib."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def show(dataset, index: int, save_path: Optional[str] = None):
    """Sample ``index``'s image and mask side by side (2D datasets)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sample = dataset[index]
    image = np.asarray(sample["image"])
    mask = np.asarray(sample["mask"])
    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    axes[0].imshow(image.squeeze(),
                   cmap="gray" if image.shape[-1] == 1 else None)
    axes[0].set_title("image")
    axes[0].axis("off")
    axes[1].imshow(mask.squeeze(), cmap="gray")
    axes[1].set_title("mask")
    axes[1].axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return save_path


def show_transform_grid(volume: np.ndarray, transforms: Sequence,
                        names: Sequence[str],
                        save_path: Optional[str] = None,
                        z: Optional[int] = None):
    """The slice ``z`` (the middle one by default) of ``volume`` and of each
    transform's output, four panels a row."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(transforms) + 1
    cols = min(n, 4)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows))
    axes = np.atleast_1d(axes).ravel()
    zz = volume.shape[0] // 2 if z is None else z

    axes[0].imshow(np.asarray(volume)[zz], cmap="gray")
    axes[0].set_title("original")
    for ax, t, name in zip(axes[1:], transforms, names):
        out = np.asarray(t(np.array(volume)))
        if out.ndim == 4:  # a label transform's channel-first stack
            out = out[0]
        ax.imshow(out[min(zz, out.shape[0] - 1)], cmap="gray")
        ax.set_title(name)
    for ax in axes:
        ax.axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return save_path

"""SSIM and MS-SSIM of channels-last images (the JAX package's
``ops/msssim.py``, pytorch_msssim's numerics):

- a separable 11-tap gaussian window, sigma 1.5, as two depthwise VALID
  convolutions;
- per level the contrast term ``cs`` ReLU'd; the product over levels
  weighted by (0.0448, 0.2856, 0.3001, 0.2363, 0.1333);
- between levels a 2×2 average pool with symmetric zero padding ``s % 2``
  per spatial dim and divisor 4.

Differentiable through autograd; the inputs' dtype is kept.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


@functools.lru_cache(maxsize=32)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable VALID gaussian blur over H and W of an NCHW tensor."""
    c, size = x.shape[1], win.shape[0]
    x = F.conv2d(x, win.reshape(1, 1, size, 1).expand(c, 1, size, 1),
                 groups=c)
    return F.conv2d(x, win.reshape(1, 1, 1, size).expand(c, 1, 1, size),
                    groups=c)


def _ssim_maps(x: torch.Tensor, y: torch.Tensor, *, data_range: float,
               win_size: int, win_sigma: float, k: Tuple[float, float],
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean SSIM and CS over the VALID interior of NCHW
    tensors, shape (N, C)."""
    c1 = (k[0] * data_range) ** 2
    c2 = (k[1] * data_range) ** 2
    win = torch.from_numpy(_gaussian_window(win_size, win_sigma)).to(
        device=x.device, dtype=x.dtype)
    mu1, mu2 = _blur(x, win), _blur(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(x * x, win) - mu1_sq
    sigma2_sq = _blur(y * y, win) - mu2_sq
    sigma12 = _blur(x * y, win) - mu1_mu2
    cs_map = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2.0 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))


def _avg_pool2_padded(x: torch.Tensor) -> torch.Tensor:
    """2×2/2 average pool with symmetric zero pad (s % 2), divisor 4."""
    pads = tuple(s % 2 for s in x.shape[2:])
    return F.avg_pool2d(x, 2, 2, padding=pads, count_include_pad=True)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def ssim(x: torch.Tensor, y: torch.Tensor, *, data_range: float = 1.0,
         win_size: int = 11, win_sigma: float = 1.5,
         k: Tuple[float, float] = (0.01, 0.03),
         size_average: bool = True) -> torch.Tensor:
    """Single-scale SSIM of NHWC images."""
    s, _ = _ssim_maps(_nchw(x), _nchw(y), data_range=data_range,
                      win_size=win_size, win_sigma=win_sigma, k=k)
    return s.mean() if size_average else s


def ms_ssim(x: torch.Tensor, y: torch.Tensor, *, data_range: float = 1.0,
            win_size: int = 11, win_sigma: float = 1.5,
            weights: Sequence[float] = MS_SSIM_WEIGHTS,
            k: Tuple[float, float] = (0.01, 0.03),
            size_average: bool = True) -> torch.Tensor:
    """Multi-scale SSIM of NHWC images.  Needs min(H, W) >
    (win_size − 1)·2^(levels − 1): 161 px for the defaults."""
    smaller = min(x.shape[1], x.shape[2])
    levels = len(weights)
    if smaller <= (win_size - 1) * 2 ** (levels - 1):
        raise ValueError(
            f"image too small for {levels}-level ms_ssim with "
            f"win_size={win_size}: min spatial dim {smaller}")
    x, y = _nchw(x), _nchw(y)
    vals = []
    for i in range(levels):
        s, cs = _ssim_maps(x, y, data_range=data_range, win_size=win_size,
                           win_sigma=win_sigma, k=k)
        if i < levels - 1:
            vals.append(F.relu(cs))
            x, y = _avg_pool2_padded(x), _avg_pool2_padded(y)
        else:
            vals.append(F.relu(s))
    stacked = torch.stack(vals)  # (levels, N, C)
    w = torch.tensor(weights, dtype=stacked.dtype,
                     device=stacked.device).reshape(-1, 1, 1)
    out = torch.prod(stacked ** w, dim=0)
    return out.mean() if size_average else out

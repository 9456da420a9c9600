"""Volumetric (3D) augmentation and the ``Transformer`` factory (the JAX
package's ``transforms/volume.py``), host side, numpy and scipy.

The transforms run in the loader threads on numpy arrays in ZYX / CZYX
(channel-first) order, as the JAX package's do, and give the same bits for
the same seed; the terminal ``ToTensor`` / ``LabelToTensor`` turn them
channels-last ((Z, Y, X, C) numpy), ready for the device.

Random-geometry lock: every transform of the raw, label and weight
pipelines is seeded with the *same* seed, drawn once per ``Transformer``
from the module's ``GLOBAL_RANDOM_STATE = RandomState(47)``; each pipeline
position consumes its own RandomState identically, so raw and label get
the same random geometry.  Kept on purpose: ``RandomFlip`` flips when a
draw exceeds ``axis_prob`` (the configured value is the chance of *not*
flipping).

skimage primitives (find_boundaries, connected components, gaussian) come
from ``.skimage_compat``; scipy.ndimage supplies rotate / map_coordinates /
gaussian_filter / convolve.
"""

from __future__ import annotations

import random as _pyrandom
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from scipy.ndimage import convolve, gaussian_filter, map_coordinates, rotate

from ..configs.registry import Registry
from .skimage_compat import find_boundaries, gaussian, label as cc_label

# a fixed random state, for reproducibility (the JAX package's too)
GLOBAL_RANDOM_STATE = np.random.RandomState(47)

TRANSFORMS = Registry("transform")


def _recover_ignore_index(input, orig, ignore_index):
    if ignore_index is not None:
        mask = orig == ignore_index
        input[mask] = ignore_index
    return input


@TRANSFORMS.register("Compose")
class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, m):
        for t in self.transforms:
            m = t(m)
        return m


@TRANSFORMS.register("RandomFlip")
class RandomFlip:
    """Random flips across each of the three spatial axes.
    Parity quirk preserved: flips when uniform() > axis_prob (i.e. the
    configured probability is the probability of NOT flipping)."""

    def __init__(self, random_state, axis_prob=0.5, **kwargs):
        assert random_state is not None, "a seeded RandomState is required (raw/label geometry lock)"
        self.random_state = random_state
        self.axes = (0, 1, 2)
        self.axis_prob = axis_prob

    def __call__(self, m):
        assert m.ndim in [3, 4], f"expected DxHxW or CxDxHxW, got ndim={m.ndim}"
        for axis in self.axes:
            if self.random_state.uniform() > self.axis_prob:
                if m.ndim == 3:
                    m = np.flip(m, axis)
                else:
                    m = np.stack([np.flip(m[c], axis) for c in range(m.shape[0])])
        return m


@TRANSFORMS.register("RandomRotate90")
class RandomRotate90:
    """k∈[0,4) quarter-turns in the YX plane."""

    def __init__(self, random_state, **kwargs):
        self.random_state = random_state
        self.axis = (1, 2)

    def __call__(self, m):
        assert m.ndim in [3, 4]
        k = self.random_state.randint(0, 4)
        if m.ndim == 3:
            return np.rot90(m, k, self.axis)
        return np.stack([np.rot90(m[c], k, self.axis) for c in range(m.shape[0])])


@TRANSFORMS.register("RandomRotate")
class RandomRotate:
    """scipy rotate by a random angle around a random axis pair; order 0 for labels, cval=-1."""

    def __init__(self, random_state, angle_spectrum=30, axes=None, mode="reflect",
                 order=0, **kwargs):
        if axes is None:
            axes = [(1, 0), (2, 1), (2, 0)]
        else:
            assert isinstance(axes, list) and len(axes) > 0
        self.random_state = random_state
        self.angle_spectrum = angle_spectrum
        self.axes = axes
        self.mode = mode
        self.order = order

    def __call__(self, m):
        axis = self.axes[self.random_state.randint(len(self.axes))]
        angle = self.random_state.randint(-self.angle_spectrum, self.angle_spectrum)
        if m.ndim == 3:
            return rotate(m, angle, axes=axis, reshape=False, order=self.order,
                          mode=self.mode, cval=-1)
        return np.stack(
            [rotate(m[c], angle, axes=axis, reshape=False, order=self.order,
                    mode=self.mode, cval=-1) for c in range(m.shape[0])]
        )


@TRANSFORMS.register("RandomContrast")
class RandomContrast:
    """mean + alpha * (v − mean), clipped to [-1, 1]."""

    def __init__(self, random_state, alpha=(0.5, 1.5), mean=0.0,
                 execution_probability=0.1, **kwargs):
        self.random_state = random_state
        assert len(alpha) == 2
        self.alpha = alpha
        self.mean = mean
        self.execution_probability = execution_probability

    def __call__(self, m):
        if self.random_state.uniform() < self.execution_probability:
            alpha = self.random_state.uniform(self.alpha[0], self.alpha[1])
            return np.clip(self.mean + alpha * (m - self.mean), -1, 1)
        return m


@TRANSFORMS.register("ElasticDeformation")
class ElasticDeformation:
    """Gaussian-filtered random displacement field + map_coordinates; spline_order 0 for labels, 3 for raw."""

    def __init__(self, random_state, spline_order, alpha=2000, sigma=50,
                 execution_probability=0.1, apply_3d=True, **kwargs):
        self.random_state = random_state
        self.spline_order = spline_order
        self.alpha = alpha
        self.sigma = sigma
        self.execution_probability = execution_probability
        self.apply_3d = apply_3d

    def __call__(self, m):
        if self.random_state.uniform() < self.execution_probability:
            assert m.ndim in [3, 4]
            volume_shape = m.shape if m.ndim == 3 else m[0].shape
            if self.apply_3d:
                dz = gaussian_filter(
                    self.random_state.randn(*volume_shape), self.sigma,
                    mode="reflect",
                ) * self.alpha
            else:
                dz = np.zeros_like(m)
            dy, dx = [
                gaussian_filter(
                    self.random_state.randn(*volume_shape), self.sigma,
                    mode="reflect",
                ) * self.alpha
                for _ in range(2)
            ]
            z_dim, y_dim, x_dim = volume_shape
            z, y, x = np.meshgrid(
                np.arange(z_dim), np.arange(y_dim), np.arange(x_dim), indexing="ij"
            )
            indices = z + dz, y + dy, x + dx
            if m.ndim == 3:
                return map_coordinates(m, indices, order=self.spline_order,
                                       mode="reflect")
            return np.stack(
                [map_coordinates(c, indices, order=self.spline_order,
                                 mode="reflect") for c in m]
            )
        return m


@TRANSFORMS.register("CropToFixed")
class CropToFixed:
    """Random (or centered) fixed-size YX crop with reflect padding when the
    requested size exceeds the volume."""

    def __init__(self, random_state, size=(256, 256), centered=False, **kwargs):
        self.random_state = random_state
        self.crop_y, self.crop_x = size
        self.centered = centered

    def __call__(self, m):
        def _padding(pad_total):
            half_total = pad_total // 2
            return (half_total, pad_total - half_total)

        def _rand_range_and_pad(crop_size, max_size):
            if crop_size < max_size:
                return max_size - crop_size, (0, 0)
            return 1, _padding(crop_size - max_size)

        def _start_and_pad(crop_size, max_size):
            if crop_size < max_size:
                return (max_size - crop_size) // 2, (0, 0)
            return 0, _padding(crop_size - max_size)

        assert m.ndim in (3, 4)
        y, x = m.shape[-2], m.shape[-1]

        if not self.centered:
            y_range, y_pad = _rand_range_and_pad(self.crop_y, y)
            x_range, x_pad = _rand_range_and_pad(self.crop_x, x)
            y_start = self.random_state.randint(y_range)
            x_start = self.random_state.randint(x_range)
        else:
            y_start, y_pad = _start_and_pad(self.crop_y, y)
            x_start, x_pad = _start_and_pad(self.crop_x, x)

        if m.ndim == 3:
            result = m[:, y_start : y_start + self.crop_y,
                       x_start : x_start + self.crop_x]
            return np.pad(result, pad_width=((0, 0), y_pad, x_pad), mode="reflect")
        channels = []
        for c in range(m.shape[0]):
            result = m[c][:, y_start : y_start + self.crop_y,
                          x_start : x_start + self.crop_x]
            channels.append(
                np.pad(result, pad_width=((0, 0), y_pad, x_pad), mode="reflect")
            )
        return np.stack(channels, axis=0)


class AbstractLabelToBoundary:
    """Conv-kernel affinity extraction base."""

    AXES_TRANSPOSE = [
        (0, 1, 2),  # X
        (0, 2, 1),  # Y
        (2, 0, 1),  # Z
    ]

    def __init__(self, ignore_index=None, aggregate_affinities=False,
                 append_label=False, **kwargs):
        self.ignore_index = ignore_index
        self.aggregate_affinities = aggregate_affinities
        self.append_label = append_label

    def __call__(self, m):
        assert m.ndim == 3
        kernels = self.get_kernels()
        boundary_arr = [
            np.where(np.abs(convolve(m, kernel)) > 0, 1, 0) for kernel in kernels
        ]
        channels = np.stack(boundary_arr)
        results = []
        if self.aggregate_affinities:
            assert len(kernels) % 3 == 0, (
                "Number of kernels must be divided by 3 (one kernel per offset "
                "per Z,Y,X axes"
            )
            for i in range(0, len(kernels), 3):
                xyz = np.logical_or.reduce(channels[i : i + 3, ...]).astype(np.int32)
                results.append(_recover_ignore_index(xyz, m, self.ignore_index))
        else:
            results = [
                _recover_ignore_index(channels[i], m, self.ignore_index)
                for i in range(channels.shape[0])
            ]
        if self.append_label:
            results.append(m)
        return np.stack(results, axis=0)

    @staticmethod
    def create_kernel(axis, offset):
        k_size = offset + 1
        k = np.zeros((1, 1, k_size), dtype=np.int32)
        k[0, 0, 0] = 1
        k[0, 0, offset] = -1
        return np.transpose(k, axis)

    def get_kernels(self):
        raise NotImplementedError


@TRANSFORMS.register("StandardLabelToBoundary")
class StandardLabelToBoundary:
    """find_boundaries(connectivity=2) boundary channel."""

    def __init__(self, ignore_index=None, append_label=False, mode="thick",
                 foreground=False, **kwargs):
        self.ignore_index = ignore_index
        self.append_label = append_label
        self.mode = mode
        self.foreground = foreground

    def __call__(self, m):
        assert m.ndim == 3
        boundaries = find_boundaries(m, connectivity=2, mode=self.mode).astype("int32")
        results = []
        if self.foreground:
            foreground = (m > 0).astype("uint8")
            results.append(_recover_ignore_index(foreground, m, self.ignore_index))
        results.append(_recover_ignore_index(boundaries, m, self.ignore_index))
        if self.append_label:
            results.append(m)
        return np.stack(results, axis=0)


@TRANSFORMS.register("BlobsToMask")
class BlobsToMask:
    """label>0 → binary mask, optional outer-boundary channel/class."""

    def __init__(self, append_label=False, boundary=False, cross_entropy=False,
                 **kwargs):
        self.cross_entropy = cross_entropy
        self.boundary = boundary
        self.append_label = append_label

    def __call__(self, m):
        assert m.ndim == 3
        mask = (m > 0).astype("uint8")
        results = [mask]
        if self.boundary:
            outer = find_boundaries(m, connectivity=2, mode="outer")
            if self.cross_entropy:
                mask[outer > 0] = 2
                results = [mask]
            else:
                results.append(outer)
        if self.append_label:
            results.append(m)
        return np.stack(results, axis=0)


@TRANSFORMS.register("RandomLabelToAffinities")
class RandomLabelToAffinities(AbstractLabelToBoundary):
    """Single random-offset, random-axis affinity channel."""

    def __init__(self, random_state, max_offset=10, ignore_index=None,
                 append_label=False, z_offset_scale=2, **kwargs):
        super().__init__(ignore_index=ignore_index, append_label=append_label,
                         aggregate_affinities=False)
        self.random_state = random_state
        self.offsets = tuple(range(1, max_offset + 1))
        self.z_offset_scale = z_offset_scale

    def get_kernels(self):
        rand_offset = self.random_state.choice(self.offsets)
        axis_ind = self.random_state.randint(3)
        if axis_ind == 2:
            rand_offset = max(1, rand_offset // self.z_offset_scale)
        rand_axis = self.AXES_TRANSPOSE[axis_ind]
        return [self.create_kernel(rand_axis, rand_offset)]


@TRANSFORMS.register("LabelToAffinities")
class LabelToAffinities(AbstractLabelToBoundary):
    """Affinity channels for every (offset, axis) pair."""

    def __init__(self, offsets, ignore_index=None, append_label=False,
                 aggregate_affinities=False, z_offsets=None, **kwargs):
        super().__init__(ignore_index=ignore_index, append_label=append_label,
                         aggregate_affinities=aggregate_affinities)
        assert isinstance(offsets, (list, tuple)), f"offsets: expected list/tuple, got {type(offsets).__name__}"
        assert all(a > 0 for a in offsets), f"offsets must all be > 0: {offsets}"
        assert len(set(offsets)) == len(offsets), f"duplicate offsets: {offsets}"
        if z_offsets is not None:
            assert len(offsets) == len(z_offsets), (
                f"need one z_offset per xy offset ({len(offsets)}), got {len(z_offsets)}"
            )
        else:
            z_offsets = list(offsets)
        self.z_offsets = z_offsets
        self.kernels = []
        for xy_offset, z_offset in zip(offsets, z_offsets):
            for axis_ind, axis in enumerate(self.AXES_TRANSPOSE):
                final_offset = z_offset if axis_ind == 2 else xy_offset
                self.kernels.append(self.create_kernel(axis, final_offset))

    def get_kernels(self):
        return self.kernels


@TRANSFORMS.register("LabelToZAffinities")
class LabelToZAffinities(AbstractLabelToBoundary):
    """Z-only affinity channels."""

    def __init__(self, offsets, ignore_index=None, append_label=False, **kwargs):
        super().__init__(ignore_index=ignore_index, append_label=append_label)
        assert isinstance(offsets, (list, tuple)), f"offsets: expected list/tuple, got {type(offsets).__name__}"
        assert all(a > 0 for a in offsets), f"offsets must all be > 0: {offsets}"
        assert len(set(offsets)) == len(offsets), f"duplicate offsets: {offsets}"
        self.kernels = []
        z_axis = self.AXES_TRANSPOSE[2]
        for z_offset in offsets:
            self.kernels.append(self.create_kernel(z_axis, z_offset))

    def get_kernels(self):
        return self.kernels


@TRANSFORMS.register("LabelToBoundaryAndAffinities")
class LabelToBoundaryAndAffinities:
    """Boundary + affinity channels concatenated."""

    def __init__(self, xy_offsets, z_offsets, append_label=False, blur=False,
                 sigma=1, ignore_index=None, mode="thick", foreground=False,
                 **kwargs):
        self.l2b = StandardLabelToBoundary(
            blur=blur, sigma=sigma, ignore_index=ignore_index, mode=mode,
            foreground=foreground,
        )
        self.l2a = LabelToAffinities(
            offsets=xy_offsets, z_offsets=z_offsets, append_label=append_label,
            ignore_index=ignore_index,
        )

    def __call__(self, m):
        return np.concatenate((self.l2b(m), self.l2a(m)), axis=0)


@TRANSFORMS.register("LabelToMaskAndAffinities")
class LabelToMaskAndAffinities:
    """Foreground mask + affinity channels."""

    def __init__(self, xy_offsets, z_offsets, append_label=False, background=0,
                 ignore_index=None, **kwargs):
        self.background = background
        self.l2a = LabelToAffinities(
            offsets=xy_offsets, z_offsets=z_offsets, append_label=append_label,
            ignore_index=ignore_index,
        )

    def __call__(self, m):
        mask = np.expand_dims((m > self.background).astype(np.uint8), axis=0)
        return np.concatenate((mask, self.l2a(m)), axis=0)


@TRANSFORMS.register("Standardize")
class Standardize:
    """Z-score normalization, optionally channelwise or with provided
    global stats."""

    def __init__(self, eps=1e-10, mean=None, std=None, channelwise=False, **kwargs):
        if mean is not None or std is not None:
            assert mean is not None and std is not None
        self.mean = mean
        self.std = std
        self.eps = eps
        self.channelwise = channelwise

    def __call__(self, m):
        if self.mean is not None:
            mean, std = self.mean, self.std
        elif self.channelwise:
            axes = tuple(range(1, m.ndim))
            mean = np.mean(m, axis=axes, keepdims=True)
            std = np.std(m, axis=axes, keepdims=True)
        else:
            mean = np.mean(m)
            std = np.std(m)
        return (m - mean) / np.clip(std, a_min=self.eps, a_max=None)


@TRANSFORMS.register("PercentileNormalizer")
class PercentileNormalizer:
    """(m − p1) / (p99.6 − p1) normalization."""

    def __init__(self, pmin=1, pmax=99.6, channelwise=False, eps=1e-10, **kwargs):
        self.eps = eps
        self.pmin = pmin
        self.pmax = pmax
        self.channelwise = channelwise

    def __call__(self, m):
        if self.channelwise:
            axes = tuple(range(1, m.ndim))
            pmin = np.percentile(m, self.pmin, axis=axes, keepdims=True)
            pmax = np.percentile(m, self.pmax, axis=axes, keepdims=True)
        else:
            pmin = np.percentile(m, self.pmin)
            pmax = np.percentile(m, self.pmax)
        return (m - pmin) / (pmax - pmin + self.eps)


@TRANSFORMS.register("Normalize")
class Normalize:
    """Min-max scaling to [-1, 1] (or [0, 1] with norm01), optional clipping
    bounds global or channelwise."""

    def __init__(self, min_value=None, max_value=None, norm01=False,
                 channelwise=False, eps=1e-10, **kwargs):
        if min_value is not None and max_value is not None and not channelwise:
            assert max_value > min_value
        self.min_value = min_value
        self.max_value = max_value
        self.norm01 = norm01
        self.channelwise = channelwise
        self.eps = eps

    def __call__(self, m):
        if self.channelwise:
            axes = tuple(range(1, m.ndim))
            min_value = np.min(m, axis=axes, keepdims=True)
            max_value = np.max(m, axis=axes, keepdims=True)
            if self.min_value is not None:
                for i, v in enumerate(self.min_value):
                    if v != "None":
                        min_value[i] = v
            if self.max_value is not None:
                for i, v in enumerate(self.max_value):
                    if v != "None":
                        max_value[i] = v
        else:
            min_value = np.min(m) if self.min_value is None else self.min_value
            max_value = np.max(m) if self.max_value is None else self.max_value

        norm_0_1 = (m - min_value) / (max_value - min_value + self.eps)
        if self.norm01:
            return np.clip(norm_0_1, 0, 1)
        return np.clip(2 * norm_0_1 - 1, -1, 1)


@TRANSFORMS.register("AdditiveGaussianNoise")
class AdditiveGaussianNoise:
    def __init__(self, random_state, scale=(0.0, 1.0), execution_probability=0.1,
                 **kwargs):
        self.execution_probability = execution_probability
        self.random_state = random_state
        self.scale = scale

    def __call__(self, m):
        if self.random_state.uniform() < self.execution_probability:
            std = self.random_state.uniform(self.scale[0], self.scale[1])
            return m + self.random_state.normal(0, std, size=m.shape)
        return m


@TRANSFORMS.register("AdditivePoissonNoise")
class AdditivePoissonNoise:
    def __init__(self, random_state, lam=(0.0, 1.0), execution_probability=0.1,
                 **kwargs):
        self.execution_probability = execution_probability
        self.random_state = random_state
        self.lam = lam

    def __call__(self, m):
        if self.random_state.uniform() < self.execution_probability:
            lam = self.random_state.uniform(self.lam[0], self.lam[1])
            return m + self.random_state.poisson(lam, size=m.shape)
        return m


@TRANSFORMS.register("ToTensor")
class ToTensor:
    """Terminal transform: numpy → channels-last float array (Z, Y, X, C),
    ready for the device."""

    def __init__(self, expand_dims, dtype=np.float32, **kwargs):
        self.expand_dims = expand_dims
        self.dtype = dtype

    def __call__(self, m):
        assert m.ndim in [3, 4], f"expected DxHxW or CxDxHxW, got ndim={m.ndim}"
        if self.expand_dims and m.ndim == 3:
            m = np.expand_dims(m, axis=0)
        if m.ndim == 4:
            m = np.moveaxis(m, 0, -1)  # CZYX → ZYXC
        else:
            m = m[..., None]
        return np.ascontiguousarray(m.astype(self.dtype))


@TRANSFORMS.register("Relabel")
class Relabel:
    """Connected components + consecutive ids."""

    def __init__(self, append_original=False, run_cc=True, ignore_label=None,
                 **kwargs):
        self.append_original = append_original
        self.ignore_label = ignore_label
        self.run_cc = run_cc
        if ignore_label is not None:
            assert append_original, (
                "ignore_label present, so append_original must be true, so that "
                "one can localize the ignore region"
            )

    def __call__(self, m):
        orig = m
        if self.run_cc:
            m = cc_label(m, background=self.ignore_label)
        _, unique_labels = np.unique(m, return_inverse=True)
        result = unique_labels.reshape(m.shape)
        if self.append_original:
            result = np.stack([result, orig])
        return result


@TRANSFORMS.register("Identity")
class Identity:
    def __init__(self, **kwargs):
        pass

    def __call__(self, m):
        return m


@TRANSFORMS.register("RgbToLabel")
class RgbToLabel:
    def __call__(self, img):
        # int64 up front: under numpy 2.x, `uint8_array * 65536` raises
        # OverflowError (NEP-50 weak-scalar promotion)
        img = np.array(img).astype(np.int64)
        assert img.ndim == 3 and img.shape[2] == 3
        return img[..., 0] * 65536 + img[..., 1] * 256 + img[..., 2]


@TRANSFORMS.register("LabelToTensor")
class LabelToTensor:
    """Terminal label transform → channels-last int64 numpy."""

    def __call__(self, m):
        m = np.array(m)
        if m.ndim == 4:
            m = np.moveaxis(m, 0, -1)
        return np.ascontiguousarray(m.astype("int64"))


@TRANSFORMS.register("GaussianBlur3D")
class GaussianBlur3D:
    def __init__(self, sigma=(0.1, 2.0), execution_probability=0.5, **kwargs):
        self.sigma = sigma
        self.execution_probability = execution_probability

    def __call__(self, x):
        if _pyrandom.random() < self.execution_probability:
            sigma = _pyrandom.uniform(self.sigma[0], self.sigma[1])
            return gaussian(x, sigma=sigma)
        return x


class Transformer:
    """Builds raw/label/weight pipelines from a phase config, with the
    shared-seed geometry lock."""

    def __init__(self, phase_config: Dict[str, Any], base_config: Dict[str, Any]):
        self.phase_config = phase_config
        self.config_base = base_config
        self.seed = GLOBAL_RANDOM_STATE.randint(10000000)

    def raw_transform(self):
        return self._create_transform("raw")

    def label_transform(self):
        return self._create_transform("label")

    def weight_transform(self):
        return self._create_transform("weight")

    @staticmethod
    def _transformer_class(class_name):
        return TRANSFORMS.get(class_name)

    def _create_transform(self, name):
        assert name in self.phase_config, f"phase config has no '{name}' pipeline"
        return Compose(
            [self._create_augmentation(c) for c in self.phase_config[name]]
        )

    def _create_augmentation(self, c):
        config = dict(self.config_base)
        config.update(c)
        config["random_state"] = np.random.RandomState(self.seed)
        aug_class = self._transformer_class(config["name"])
        return aug_class(**config)

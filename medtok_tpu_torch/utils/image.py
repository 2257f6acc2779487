"""ADM-style center crop-and-resize on arrays (counterpart of
``medtok_tpu/utils/image.py``): 2x area halving while the short side is at
least twice the target, one cubic resize that puts the short side at the
target, then a center crop.

The resize computes what the JAX version's ``jax.image.resize(...,
method="cubic")`` computes, in numpy: separable Keys cubic weights with a =
-0.5, pixel centres at half pixels, the kernel widened by 1 / scale when
downsampling (antialiased), each output's weights renormalised to sum to 1
and zero where its sample falls outside the input. (``torch.nn.functional.
interpolate(mode="bicubic")`` uses a = -0.75 and does not widen the kernel,
so it gives other values.)
"""

from __future__ import annotations

import numpy as np


def _halve_area(arr: np.ndarray) -> np.ndarray:
    """2x downsample by area averaging (PIL BOX at factor 2); an odd
    trailing row / column is dropped first."""
    h2, w2 = arr.shape[0] // 2, arr.shape[1] // 2
    a = arr[: h2 * 2, : w2 * 2].astype(np.float32)
    return a.reshape(h2, 2, w2, 2, *arr.shape[2:]).mean(axis=(1, 3))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel (a = -0.5) at |x|."""
    out = (1.5 * x - 2.5) * x * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float64 weights of a cubic resize along one axis,
    as ``jax.image.scale_and_translate`` builds them (no translation)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    w = _keys_cubic(np.abs(sample[None, :] - np.arange(in_size)[:, None]) / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize_cubic(arr: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """HW or HWC float array resized to (new_h, new_w) by ``cubic_weights``
    along each axis whose size changes; float32 out."""
    out = arr.astype(np.float64)
    if new_h != out.shape[0]:
        out = np.tensordot(cubic_weights(out.shape[0], new_h), out, axes=([0], [0]))
    if new_w != out.shape[1]:
        out = np.moveaxis(np.tensordot(cubic_weights(out.shape[1], new_w), out,
                                       axes=([0], [1])), 0, 1)
    return out.astype(np.float32)


def center_crop_arr(arr: np.ndarray, image_size: int) -> np.ndarray:
    """Crop-and-resize an HWC (or HW) image array to image_size x
    image_size. Returns the input dtype (integer inputs are rounded and
    clipped back to it)."""
    if image_size <= 0:
        raise ValueError(f"image_size must be positive, got {image_size}")
    if arr.ndim not in (2, 3):
        raise ValueError(f"expected HW or HWC array, got shape {arr.shape}")
    in_dtype = arr.dtype
    out = arr.astype(np.float32)
    while min(out.shape[0], out.shape[1]) >= 2 * image_size:
        out = _halve_area(out)

    scale = image_size / min(out.shape[0], out.shape[1])
    new_h, new_w = round(out.shape[0] * scale), round(out.shape[1] * scale)
    if (new_h, new_w) != out.shape[:2]:
        out = resize_cubic(out, new_h, new_w)

    crop_y = (out.shape[0] - image_size) // 2
    crop_x = (out.shape[1] - image_size) // 2
    out = out[crop_y: crop_y + image_size, crop_x: crop_x + image_size]
    if np.issubdtype(in_dtype, np.integer):
        info = np.iinfo(in_dtype)
        out = np.clip(np.rint(out), info.min, info.max).astype(in_dtype)
    return out

"""Image preprocessing, inception style; counterpart of
comic_tpu/data/preprocessing.py (reference
inception_preprocessing_radix.py:158-278).

Host: decode a file and resize it to a fixed 256x256 uint8 RGB image
(cv2, else PIL, imported lazily). Device: the batch crosses as uint8 NHWC
and becomes the encoder's NCHW float input in one function:
  train: random horizontal flip -> random (out_h, out_w) crop
  eval:  central crop-or-pad to (out_h, out_w)
  then /255 -> (x - .5) * 2.
The train-time draws (a flip and two crop offsets per image) come from an
explicit ``torch.Generator``; ``augment`` takes them as tensors, so a test
can give it comic_tpu's. The VGG/ResNet path waits for a later slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

RESIZE_SIZE = 256


def central_crop_or_pad(images: torch.Tensor, out_h: int, out_w: int
                        ) -> torch.Tensor:
    """tf.image.resize_image_with_crop_or_pad on a (B, H, W, C) batch:
    center crop, zero pad."""
    h, w = images.shape[1], images.shape[2]
    off_h = max((h - out_h) // 2, 0)
    off_w = max((w - out_w) // 2, 0)
    out = images[:, off_h: off_h + min(h, out_h), off_w: off_w + min(w, out_w)]
    pad_h, pad_w = out_h - out.shape[1], out_w - out.shape[2]
    if pad_h > 0 or pad_w > 0:
        out = torch.nn.functional.pad(
            out, (0, 0, pad_w // 2, pad_w - pad_w // 2,
                  pad_h // 2, pad_h - pad_h // 2))
    return out


def draw_augment(generator: torch.Generator, batch: int, in_h: int,
                 in_w: int, out_h: int, out_w: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flips (B,) bool, off_y (B,), off_x (B,)) on the generator's device:
    a fair coin per image and crop offsets uniform over every position
    that fits, as comic_tpu's _augment_one draws them."""
    dev = generator.device
    flips = torch.rand(batch, generator=generator, device=dev) < 0.5
    off_y = torch.randint(0, in_h - out_h + 1, (batch,),
                          generator=generator, device=dev)
    off_x = torch.randint(0, in_w - out_w + 1, (batch,),
                          generator=generator, device=dev)
    return flips, off_y, off_x


def augment(images: torch.Tensor, out_h: int, out_w: int,
            flips: torch.Tensor, off_y: torch.Tensor, off_x: torch.Tensor
            ) -> torch.Tensor:
    """Train augment of a (B, H, W, C) batch: image b is flipped left to
    right where flips[b], then cropped to (out_h, out_w) at (off_y[b],
    off_x[b]) of the flipped image (comic_tpu _augment_one)."""
    b, _, w, _ = images.shape
    rows = off_y[:, None] + torch.arange(out_h, device=images.device)
    cols = off_x[:, None] + torch.arange(out_w, device=images.device)
    cols = torch.where(flips[:, None], w - 1 - cols, cols)
    batch = torch.arange(b, device=images.device)[:, None, None]
    return images[batch, rows[:, :, None], cols[:, None, :]]


def preprocess_batch(images_u8, out_h: int, out_w: int,
                     device: torch.device, training: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """(B, 256, 256, 3) uint8 (numpy or tensor) -> (B, 3, out_h, out_w)
    float32 in [-1, 1] on ``device``. ``training`` takes the random flip
    and crop, drawn from ``generator``."""
    images = torch.as_tensor(images_u8).to(device, non_blocking=True)
    in_h, in_w = images.shape[1], images.shape[2]
    if out_h > in_h or out_w > in_w:
        raise ValueError(
            f"cnn_input_size ({out_h},{out_w}) exceeds the host-resized "
            f"image ({in_h},{in_w}); the reference-faithful pipeline "
            f"crops, never upsamples. Use cnn_input_size <= {in_h}.")
    if training:
        draws = draw_augment(generator, images.shape[0], in_h, in_w,
                             out_h, out_w)
        x = augment(images.float(), out_h, out_w,
                    *(t.to(device) for t in draws))
    else:
        x = central_crop_or_pad(images.float(), out_h, out_w)
    # (x / 255 - .5) * 2 as the one fused multiply-add x * (2/255) - 1 that
    # XLA folds the reference's expression into: same input bits. A zero
    # pad pixel maps to -1 either way.
    x = torch.addcmul(x.new_full((), -1.0), x, x.new_full((), 2.0 / 255.0))
    return x.permute(0, 3, 1, 2).contiguous()


def preprocess_for(cnn_name: str):
    """Encoder name -> batched preprocessing fn (reference
    preprocessing_factory.py:31-84 dispatch)."""
    from ..models.encoders import get_encoder

    if get_encoder(cnn_name).preprocessing == "vgg":
        raise NotImplementedError(
            "VGG-style preprocessing is not yet ported to comic_tpu_torch.")
    return preprocess_batch


# --------------------------------------------------------------------------
# Host-side decode/resize
# --------------------------------------------------------------------------

def decode_image_host(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8 RGB (cv2, PIL fallback)."""
    try:
        import cv2

        data = np.fromfile(path, np.uint8)
        img = cv2.imdecode(data, cv2.IMREAD_COLOR)  # BGR
        if img is None:
            raise ValueError(f"Could not decode image: {path}")
        return img[:, :, ::-1].copy()  # BGR -> RGB
    except ImportError:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.uint8)


def resize_bilinear_tf1_np(img: np.ndarray, out_h: int, out_w: int
                           ) -> np.ndarray:
    """TF1 ``tf.image.resize_bilinear`` (align_corners=False): src = dst *
    (in / out), edge-clamped, rounded back to uint8."""
    in_h, in_w = img.shape[:2]

    def axis(out_n, in_n):
        src = np.arange(out_n, dtype=np.float64) * (in_n / out_n)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, in_n - 1)
        return lo, hi, (src - lo).astype(np.float32)

    ylo, yhi, yf = axis(out_h, in_h)
    xlo, xhi, xf = axis(out_w, in_w)
    im = img.astype(np.float32)
    top = im[ylo][:, xlo] * (1 - xf)[None, :, None] \
        + im[ylo][:, xhi] * xf[None, :, None]
    bot = im[yhi][:, xlo] * (1 - xf)[None, :, None] \
        + im[yhi][:, xhi] * xf[None, :, None]
    out = top * (1 - yf)[:, None, None] + bot * yf[:, None, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _resize_host(img: np.ndarray, out_h: int, out_w: int,
                 tf1_exact: bool = False) -> np.ndarray:
    """Bilinear resize of a uint8 RGB image to (out_h, out_w, 3) (cv2, PIL
    fallback), or TF1's exact rule."""
    if tf1_exact:
        return resize_bilinear_tf1_np(img, out_h, out_w)
    try:
        import cv2

        return cv2.resize(img, (out_w, out_h),
                          interpolation=cv2.INTER_LINEAR)
    except ImportError:
        from PIL import Image

        return np.asarray(
            Image.fromarray(img).resize((out_w, out_h), Image.BILINEAR),
            np.uint8)


def load_and_resize_host(path: str, size: int = RESIZE_SIZE,
                         tf1_exact: bool = False) -> np.ndarray:
    """Decode + square bilinear resize to (size, size, 3) uint8 RGB (the
    inception-style host path)."""
    return _resize_host(decode_image_host(path), size, size, tf1_exact)

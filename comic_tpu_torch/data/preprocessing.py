"""Image preprocessing; counterpart of comic_tpu/data/preprocessing.py
(reference inception_preprocessing_radix.py:158-278 and
vgg_preprocessing.py:233-365).

Host: decode a file and resize it to a fixed 256x256 uint8 RGB image
(cv2, else PIL, imported lazily): a square resize for the inception-style
encoders; for VGG and the ResNets an aspect-preserving resize of the
smallest side (to 256 at eval, jittered in [256, 512] in training) and a
central (eval) or random (train) 256 crop. Device: the batch crosses as
uint8 NHWC and becomes the encoder's NCHW float input in one function:
  train: random horizontal flip -> random (out_h, out_w) crop
  eval:  central crop-or-pad to (out_h, out_w)
  then inception style: /255 -> (x - .5) * 2; VGG style: the RGB means
  subtracted from the 0-255 values.
The train-time draws (a flip and two crop offsets per image) come from an
explicit ``torch.Generator``; ``augment`` takes them as tensors, so a test
can give it comic_tpu's. The host's draws come from a numpy Generator
passed in, as comic_tpu's do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

RESIZE_SIZE = 256
# ImageNet RGB means of the VGG/ResNet preprocessing (vgg_preprocessing.py:
# 39-41) and the train-time bounds of the smallest side (:43-44)
VGG_MEANS_RGB = (123.68, 116.78, 103.94)
VGG_RESIZE_SIDE_MIN = 256
VGG_RESIZE_SIDE_MAX = 512


def resize_bilinear_tf1(image: torch.Tensor, out_h: int, out_w: int
                        ) -> torch.Tensor:
    """TF1 ``tf.image.resize_bilinear`` (align_corners=False) of a
    (..., H, W, C) tensor -> float32: src = dst * (in / out), edge
    clamped."""
    in_h, in_w = image.shape[-3], image.shape[-2]
    dev = image.device

    def axis_coords(out_n, in_n):
        src = torch.arange(out_n, dtype=torch.float32, device=dev) * (
            in_n / out_n)
        lo = torch.floor(src).long()
        hi = torch.clamp(lo + 1, max=in_n - 1)
        return lo, hi, src - lo.float()

    ylo, yhi, yf = axis_coords(out_h, in_h)
    xlo, xhi, xf = axis_coords(out_w, in_w)
    img = image.float()
    xf, yf = xf[:, None], yf[:, None, None]

    def rows(idx):
        r = img.index_select(-3, idx)
        return (r.index_select(-2, xlo) * (1 - xf)
                + r.index_select(-2, xhi) * xf)

    return rows(ylo) * (1 - yf) + rows(yhi) * yf


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


def check_crop(in_h: int, in_w: int, out_h: int, out_w: int) -> None:
    """Raise where the (out_h, out_w) crop is larger than the (in_h, in_w)
    image: the reference crops, never upsamples."""
    if out_h > in_h or out_w > in_w:
        raise ValueError(
            f"cnn_input_size ({out_h},{out_w}) exceeds the host-resized "
            f"image ({in_h},{in_w}); the reference-faithful pipeline "
            f"crops, never upsamples. Use cnn_input_size <= {in_h}.")


def _crop_batch(images_u8, out_h: int, out_w: int, device: torch.device,
                training: bool, generator: Optional[torch.Generator],
                draws=None) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, out_h, out_w, 3) float32 0-255 on
    ``device``: the train flip and crop (``draws``, draw_augment's triple
    for these rows, else drawn from ``generator``), or the eval central
    crop-or-pad. Raises where the crop is larger than the image."""
    images = torch.as_tensor(images_u8).to(device, non_blocking=True)
    in_h, in_w = images.shape[1], images.shape[2]
    check_crop(in_h, in_w, out_h, out_w)
    if training:
        if draws is None:
            draws = draw_augment(generator, images.shape[0], in_h, in_w,
                                 out_h, out_w)
        return augment(images.float(), out_h, out_w,
                       *(t.to(device) for t in draws))
    return central_crop_or_pad(images.float(), out_h, out_w)


def preprocess_batch(images_u8, out_h: int, out_w: int,
                     device: torch.device, training: bool = False,
                     generator: Optional[torch.Generator] = None,
                     draws=None) -> torch.Tensor:
    """(B, 256, 256, 3) uint8 (numpy or tensor) -> (B, 3, out_h, out_w)
    float32 in [-1, 1] on ``device``, inception style. ``training`` takes
    the random flip and crop: ``draws`` (draw_augment's triple for these
    rows) when given, else drawn from ``generator``."""
    x = _crop_batch(images_u8, out_h, out_w, device, training, generator,
                    draws)
    # (x / 255 - .5) * 2 as the one fused multiply-add x * (2/255) - 1 that
    # XLA folds the reference's expression into: same input bits. A zero
    # pad pixel maps to -1 either way.
    x = torch.addcmul(x.new_full((), -1.0), x, x.new_full((), 2.0 / 255.0))
    return x.permute(0, 3, 1, 2).contiguous()


def preprocess_batch_vgg(images_u8, out_h: int, out_w: int,
                         device: torch.device, training: bool = False,
                         generator: Optional[torch.Generator] = None,
                         draws=None) -> torch.Tensor:
    """The VGG/ResNet path (vgg_preprocessing.py:286-365): the same crops
    as ``preprocess_batch``, on the 0-255 values, minus the RGB means ->
    (B, 3, out_h, out_w) float32 on ``device``."""
    x = _crop_batch(images_u8, out_h, out_w, device, training, generator,
                    draws)
    x = x - torch.tensor(VGG_MEANS_RGB, dtype=torch.float32, device=x.device)
    return x.permute(0, 3, 1, 2).contiguous()


def preprocess_for(cnn_name: str):
    """Encoder name -> batched preprocessing fn (reference
    preprocessing_factory.py:31-84: inception/mobilenet/nasnet ->
    inception style, resnet/vgg -> VGG style)."""
    from ..models.encoders import get_encoder

    if get_encoder(cnn_name).preprocessing == "vgg":
        return preprocess_batch_vgg
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


def _aspect_resize_host(img: np.ndarray, smallest_side: int,
                        tf1_exact: bool = False) -> np.ndarray:
    """Aspect-preserving resize of the smallest side to ``smallest_side``,
    the other truncated (vgg_preprocessing.py:233-283)."""
    h, w = img.shape[:2]
    scale = smallest_side / (w if h > w else h)
    return _resize_host(img, int(h * scale), int(w * scale), tf1_exact)


def _center_crop_host(img: np.ndarray, size: int) -> np.ndarray:
    """Central size x size crop, zero-padded around a smaller source."""
    h, w = img.shape[:2]
    off_h, off_w = max((h - size) // 2, 0), max((w - size) // 2, 0)
    out = img[off_h: off_h + size, off_w: off_w + size]
    if out.shape[0] < size or out.shape[1] < size:
        pad_h, pad_w = size - out.shape[0], size - out.shape[1]
        out = np.pad(out, ((pad_h // 2, pad_h - pad_h // 2),
                           (pad_w // 2, pad_w - pad_w // 2), (0, 0)))
    return out


def load_and_resize_host(path: str, size: int = RESIZE_SIZE,
                         mode: str = "square", tf1_exact: bool = False,
                         rng: Optional[np.random.Generator] = None
                         ) -> np.ndarray:
    """Decode + resize to a fixed (size, size, 3) uint8 RGB image.

    Modes (one output shape, so the device sees one input shape):
      - 'square' (inception style): bilinear resize to size x size;
      - 'aspect_eval' (VGG/ResNet eval): smallest side -> size, central
        crop (with the device's central crop, the reference's resize-256
        and central 224 crop);
      - 'aspect_train' (VGG/ResNet train): smallest side jittered in
        [256, 512] from ``rng`` (vgg_preprocessing.py:308-311), then a
        random size x size crop from ``rng`` (the reference crops 224
        straight from the jittered image: the host's 256 crop and the
        device's 224 crop cover the same support). A side that truncates
        below ``size`` is center-padded instead.
    """
    img = decode_image_host(path)
    if mode == "square":
        return _resize_host(img, size, size, tf1_exact)
    if mode == "aspect_eval":
        return _center_crop_host(_aspect_resize_host(img, size, tf1_exact),
                                 size)
    if mode == "aspect_train":
        rng = rng or np.random.default_rng()
        side = max(int(rng.integers(VGG_RESIZE_SIDE_MIN,
                                    VGG_RESIZE_SIDE_MAX + 1)), size)
        img = _aspect_resize_host(img, side, tf1_exact)
        h, w = img.shape[:2]
        if h < size or w < size:
            return _center_crop_host(img, size)
        off_h = int(rng.integers(0, h - size + 1))
        off_w = int(rng.integers(0, w - size + 1))
        return img[off_h: off_h + size, off_w: off_w + size]
    raise ValueError(f"Unknown host resize mode: {mode}")

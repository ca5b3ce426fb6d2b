"""CNN encoder registry, counterpart of comic_tpu/models/encoders.py.

Produces the pooled image embedding and the flattened attention feature map
(reference model_base.py:56-104). This slice ports Inception-V1, the
default encoder and the one behind every published COMIC number; the rest
of comic_tpu's zoo raises "not yet ported".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from . import inception_v1
from .layers import dense_apply, dense_init, layer_norm_apply, layer_norm_init

Params = Dict[str, Any]


@dataclass(frozen=True)
class EncoderSpec:
    name: str
    init: Callable[[torch.Generator], Params]
    apply: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    pooled: Callable[[torch.Tensor], torch.Tensor]
    default_image_size: int
    feature_dim: int  # pooled embedding size
    default_fm_endpoint: str
    fm_channels: Dict[str, int]  # endpoint -> channel count
    preprocessing: str  # 'inception' | 'vgg' (see data/preprocessing.py)


_REGISTRY: Dict[str, EncoderSpec] = {
    "inception_v1": EncoderSpec(
        name="inception_v1",
        init=inception_v1.init_params,
        apply=inception_v1.apply,
        pooled=inception_v1.pooled_features,
        default_image_size=inception_v1.DEFAULT_IMAGE_SIZE,
        feature_dim=inception_v1.FEATURE_DIM,
        default_fm_endpoint="Mixed_4f",
        fm_channels={
            "Mixed_3c": 480, "Mixed_4b": 512, "Mixed_4c": 512,
            "Mixed_4d": 512, "Mixed_4e": 528, "Mixed_4f": 832,
            "Mixed_5b": 832, "Mixed_5c": 1024,
        },
        preprocessing="inception",
    ),
}

# comic_tpu's other encoders, which later slices port
_NOT_YET_PORTED = (
    "inception_v2", "inception_v3", "inception_v4", "inception_resnet_v2",
    "resnet_v1_50", "resnet_v1_101", "resnet_v1_152", "resnet_v2_50",
    "resnet_v2_101", "resnet_v2_152", "vgg_16", "vgg_19", "mobilenet_v1",
    "mobilenet_v2", "mobilenet_v2_140", "nasnet_mobile", "nasnet_large",
    "pnasnet_mobile", "pnasnet_large",
)


def get_encoder(name: str) -> EncoderSpec:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"Encoder {name} is not yet ported to comic_tpu_torch.")
    raise ValueError(
        f"Name of network unknown {name}. Known: {sorted(_REGISTRY)}")


def encoder_init(generator: torch.Generator, cnn_name: str,
                 legacy: bool = False) -> Params:
    """CNN params (+ the legacy LN-tanh/linear image-embed head,
    reference model_base.py:80-91)."""
    spec = get_encoder(cnn_name)
    p: Params = {"cnn": spec.init(generator)}
    if legacy:
        p["LN_tanh"] = layer_norm_init(spec.feature_dim)
        p["im_embed"] = dense_init(generator, spec.feature_dim, 1024,
                                   use_bias=False)
    return p


def encode_images(
    params: Params,
    images: torch.Tensor,
    cnn_name: str,
    fm_endpoint: Optional[str] = None,
    legacy: bool = False,
    dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (B, 3, H, W) -> (im_embed (B, E), fmaps (B, H'*W', C)).

    The attention memory is the chosen endpoint flattened row-major over
    (H', W'), the same position order as comic_tpu's NHWC reshape.
    """
    spec = get_encoder(cnn_name)
    fm_endpoint = fm_endpoint or spec.default_fm_endpoint
    net, end_points = spec.apply(params["cnn"], images, dtype=dtype)
    im_embed = spec.pooled(net)
    if legacy:
        im_embed = layer_norm_apply(params["LN_tanh"], im_embed,
                                    activation=torch.tanh)
        im_embed = dense_apply(params["im_embed"], im_embed, dtype=dtype)
    fm = end_points[fm_endpoint]
    return im_embed, fm.flatten(2).transpose(1, 2).contiguous()

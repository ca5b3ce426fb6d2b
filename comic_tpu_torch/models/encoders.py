"""CNN encoder registry, counterpart of comic_tpu/models/encoders.py.

Produces the pooled image embedding and the flattened attention feature map
(reference model_base.py:56-104), for every encoder comic_tpu registers:
Inception-V1 (the default, behind every published COMIC number), V2, V3,
V4 and Inception-ResNet-V2, ResNet-v1 and v2 (50/101/152), VGG-16/19,
MobileNet-V1, V2 and V2-1.4, NASNet-A and PNASNet-5 (mobile and large).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import (inception_resnet_v2, inception_v1, inception_v2, inception_v3,
               inception_v4, mobilenet_v1, mobilenet_v2, nasnet, resnet,
               resnet_v2, vgg)
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


_REGISTRY: Dict[str, EncoderSpec] = {}


def register(spec: EncoderSpec) -> None:
    _REGISTRY[spec.name] = spec


def get_encoder(name: str) -> EncoderSpec:
    if name not in _REGISTRY:
        raise ValueError(
            f"Name of network unknown {name}. Known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_encoders() -> List[str]:
    return sorted(_REGISTRY)


def _module_spec(name, module, fm_endpoint, fm_channels,
                 preprocessing="inception", **over) -> EncoderSpec:
    """A spec from a module's init/apply/pooled_features and constants
    (DEFAULT_IMAGE_SIZE, FEATURE_DIM), each replaceable through ``over``."""
    fields = dict(init=module.init_params, apply=module.apply,
                  pooled=module.pooled_features)
    fields.update(over)
    for key, const in (("default_image_size", "DEFAULT_IMAGE_SIZE"),
                       ("feature_dim", "FEATURE_DIM")):
        if key not in fields:
            fields[key] = getattr(module, const)
    return EncoderSpec(name=name, default_fm_endpoint=fm_endpoint,
                       fm_channels=fm_channels, preprocessing=preprocessing,
                       **fields)


def _named_spec(name, module, default_final, fm_endpoint, fm_channels,
                preprocessing="inception", **over) -> EncoderSpec:
    """A spec for a module that builds several nets, picked by ``name``."""
    return _module_spec(
        name, module, fm_endpoint, fm_channels, preprocessing,
        init=lambda g: module.init_params(g, name),
        apply=lambda p, x, final_endpoint=default_final, dtype=None:
            module.apply(p, x, name, final_endpoint, dtype),
        **over)


register(_module_spec(
    "inception_v1", inception_v1, "Mixed_4f",
    {"Mixed_3c": 480, "Mixed_4b": 512, "Mixed_4c": 512, "Mixed_4d": 512,
     "Mixed_4e": 528, "Mixed_4f": 832, "Mixed_5b": 832, "Mixed_5c": 1024}))
register(_module_spec("inception_v2", inception_v2, "Mixed_4e",
                      {"Mixed_3c": 320, "Mixed_4e": 576, "Mixed_5c": 1024}))
register(_module_spec("inception_v3", inception_v3, "Mixed_6e",
                      {"Mixed_5d": 288, "Mixed_6e": 768, "Mixed_7c": 2048}))
register(_module_spec("inception_v4", inception_v4, "Mixed_6h",
                      {"Mixed_5e": 384, "Mixed_6h": 1024, "Mixed_7d": 1536}))
register(_module_spec(
    "inception_resnet_v2", inception_resnet_v2, "PreAuxLogits",
    {"Mixed_5b": 320, "Mixed_6a": 1088, "PreAuxLogits": 1088,
     "Mixed_7a": 2080, "Conv2d_7b_1x1": 1536}))
for _name in resnet.RESNET_V1_UNITS:
    register(_named_spec(_name, resnet, "block4", "block3",
                         {"block1": 256, "block2": 512, "block3": 1024,
                          "block4": 2048}, "vgg"))
for _name in resnet_v2.RESNET_V2_UNITS:
    register(_named_spec(_name, resnet_v2, "postnorm", "block3",
                         {"block1": 256, "block2": 512, "block3": 1024,
                          "block4": 2048, "postnorm": 2048}, "vgg"))
# per net: vgg_16 has no conv5_4, so a shared endpoint table would pass
# build_model_spec's check and fail later inside encode_images
register(_named_spec("vgg_16", vgg, "fc7", "conv5_3",
                     {"conv4_3": 512, "conv5_3": 512}, "vgg"))
register(_named_spec("vgg_19", vgg, "fc7", "conv5_4",
                     {"conv4_3": 512, "conv4_4": 512, "conv5_3": 512,
                      "conv5_4": 512}, "vgg"))
register(_module_spec(
    "mobilenet_v1", mobilenet_v1, "Conv2d_11_pointwise",
    {"Conv2d_11_pointwise": 512, "Conv2d_13_pointwise": 1024}))
register(_module_spec(
    "mobilenet_v2", mobilenet_v2, "expanded_conv_12",
    {"expanded_conv_12": 96, "expanded_conv_16": 320, "Conv_1": 1280}))
# depth multiplier 1.4 (reference common/net_params.py:85-90): every width
# through make_divisible(c * 1.4, 8): 96 -> 136, 320 -> 448, 1280 -> 1792
register(_module_spec(
    "mobilenet_v2_140", mobilenet_v2, "expanded_conv_12",
    {"expanded_conv_12": 136, "expanded_conv_16": 448, "Conv_1": 1792},
    init=lambda g: mobilenet_v2.init_params(g, depth_multiplier=1.4),
    feature_dim=mobilenet_v2.feature_dim(1.4)))
# the default attention endpoints are the stride-16 maps (14x14 at 224),
# the altitude of Inception-V1's Mixed_4f
for _name, (_ep, _channels) in {
        "nasnet_mobile": ("Cell_7", {"Cell_3": 264, "Cell_7": 528,
                                     "Cell_11": 1056}),
        "nasnet_large": ("Cell_11", {"Cell_5": 1008, "Cell_11": 2016,
                                     "Cell_17": 4032}),
        "pnasnet_mobile": ("Cell_5", {"Cell_2": 270, "Cell_5": 540,
                                      "Cell_8": 1080}),
        "pnasnet_large": ("Cell_7", {"Cell_3": 1080, "Cell_7": 2160,
                                     "Cell_11": 4320})}.items():
    register(_named_spec(_name, nasnet, None, _ep, _channels,
                         default_image_size=nasnet.DEFAULT_IMAGE_SIZES[_name],
                         feature_dim=nasnet.FEATURE_DIMS[_name]))


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

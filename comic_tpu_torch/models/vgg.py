"""VGG-16/19 image encoders, counterpart of comic_tpu/models/vgg.py (slim
vgg.py).

Plain conv + bias + relu, no batch norm; 2x2/2 VALID max pools between the
five conv blocks; fc6 and fc7 are convolutions (7x7 VALID, then 1x1), so
the pooled feature is fc7 averaged over what is left of the map (1x1 at
224), (B, 4096). Param keys are slim's (conv{i}/conv{i}_{j}/{weights,
biases}, fc6, fc7). VGG preprocessing (mean-subtracted 0-255 RGB). NCHW.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from . import layers

Params = Dict[str, Any]

VGG_LAYERS = {
    "vgg_16": (2, 2, 3, 3, 3),
    "vgg_19": (2, 2, 4, 4, 4),
}
_WIDTHS = (64, 128, 256, 512, 512)
DEFAULT_IMAGE_SIZE = 224
FEATURE_DIM = 4096


def _conv_init(g: torch.Generator, k: int, cin: int, cout: int) -> Params:
    """Glorot-uniform kernel (OIHW) and zero biases."""
    limit = math.sqrt(6.0 / (k * k * cin + k * k * cout))
    return {"weights": torch.empty(cout, cin, k, k).uniform_(
                -limit, limit, generator=g),
            "biases": torch.zeros(cout)}


def init_params(generator: torch.Generator, name: str = "vgg_16") -> Params:
    """The full parameter tree (no fc8 classifier), on the CPU."""
    params: Params = {}
    cin = 3
    for bi, (n, width) in enumerate(zip(VGG_LAYERS[name], _WIDTHS), 1):
        block: Params = {}
        for li in range(1, n + 1):
            block[f"conv{bi}_{li}"] = _conv_init(generator, 3, cin, width)
            cin = width
        params[f"conv{bi}"] = block
    params["fc6"] = _conv_init(generator, 7, 512, 4096)
    params["fc7"] = _conv_init(generator, 1, 4096, 4096)
    return params


def _conv(p, x, padding="SAME", dtype=None):
    y = layers.conv_f32(x, p["weights"], 1, padding, dtype)
    return torch.relu(y + p["biases"].view(1, -1, 1, 1))


def apply(params: Params, images: torch.Tensor, name: str = "vgg_16",
          final_endpoint: str = "fc7", dtype: Optional[torch.dtype] = None,
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, 3, H, W) mean-subtracted -> (net, end_points), float32 NCHW."""
    counts = VGG_LAYERS[name]
    valid = {f"conv{bi}_{li}" for bi, n in enumerate(counts, 1)
             for li in range(1, n + 1)}
    valid |= {f"pool{bi}" for bi in range(1, len(counts) + 1)}
    valid |= {"fc6", "fc7"}
    if final_endpoint not in valid:
        # slim raises for unknown endpoints, as comic_tpu does
        raise ValueError(f"Unknown {name} endpoint {final_endpoint!r}")
    end_points: Dict[str, torch.Tensor] = {}
    net = images
    for bi, n in enumerate(counts, 1):
        for li in range(1, n + 1):
            ep = f"conv{bi}_{li}"
            net = _conv(params[f"conv{bi}"][ep], net, dtype=dtype)
            end_points[ep] = net
            if ep == final_endpoint:
                return net, end_points
        net = layers.max_pool(net, 2, 2, "VALID")
        end_points[f"pool{bi}"] = net
        if f"pool{bi}" == final_endpoint:
            return net, end_points
    net = _conv(params["fc6"], net, "VALID", dtype)
    end_points["fc6"] = net
    if final_endpoint == "fc6":
        return net, end_points
    net = _conv(params["fc7"], net, dtype=dtype)
    end_points["fc7"] = net
    return net, end_points


def pooled_features(net: torch.Tensor) -> torch.Tensor:
    return net.mean(dim=(2, 3))

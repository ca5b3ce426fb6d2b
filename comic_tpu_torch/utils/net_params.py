"""Pretrained-encoder checkpoint registry; counterpart of
comic_tpu/utils/net_params.py (reference common/net_params.py:19-106): maps
encoder names to their published slim ImageNet checkpoints and resolves
local checkpoint paths (default ``<repo>/ckpt``). ``maybe_get_ckpt_file``
uses files already on disk unless the caller allows a download, and
converts a slim checkpoint at first use into ``<ckpt>.msgpack`` through
this package's converter (utils/tf_checkpoint.py, which needs
TensorFlow).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CKPT_DIR = os.path.join(_REPO_ROOT, "ckpt")

# name -> (tarball url, ckpt basename inside the tarball) — the full
# reference registry (common/net_params.py:19-91)
_TF_DL = "http://download.tensorflow.org/models/"
NET_PARAMS: Dict[str, Dict[str, str]] = {
    "inception_v1": dict(url=_TF_DL + "inception_v1_2016_08_28.tar.gz",
                         ckpt="inception_v1.ckpt"),
    "inception_v2": dict(url=_TF_DL + "inception_v2_2016_08_28.tar.gz",
                         ckpt="inception_v2.ckpt"),
    "inception_v3": dict(url=_TF_DL + "inception_v3_2016_08_28.tar.gz",
                         ckpt="inception_v3.ckpt"),
    "inception_v4": dict(url=_TF_DL + "inception_v4_2016_09_09.tar.gz",
                         ckpt="inception_v4.ckpt"),
    "inception_resnet_v2": dict(
        url=_TF_DL + "inception_resnet_v2_2016_08_30.tar.gz",
        ckpt="inception_resnet_v2_2016_08_30.ckpt"),
    "resnet_v1_50": dict(url=_TF_DL + "resnet_v1_50_2016_08_28.tar.gz",
                         ckpt="resnet_v1_50.ckpt"),
    "resnet_v1_101": dict(url=_TF_DL + "resnet_v1_101_2016_08_28.tar.gz",
                          ckpt="resnet_v1_101.ckpt"),
    "resnet_v1_152": dict(url=_TF_DL + "resnet_v1_152_2016_08_28.tar.gz",
                          ckpt="resnet_v1_152.ckpt"),
    "resnet_v2_50": dict(url=_TF_DL + "resnet_v2_50_2017_04_14.tar.gz",
                         ckpt="resnet_v2_50.ckpt"),
    "resnet_v2_101": dict(url=_TF_DL + "resnet_v2_101_2017_04_14.tar.gz",
                          ckpt="resnet_v2_101.ckpt"),
    "resnet_v2_152": dict(url=_TF_DL + "resnet_v2_152_2017_04_14.tar.gz",
                          ckpt="resnet_v2_152.ckpt"),
    "vgg_16": dict(url=_TF_DL + "vgg_16_2016_08_28.tar.gz",
                   ckpt="vgg_16.ckpt"),
    "vgg_19": dict(url=_TF_DL + "vgg_19_2016_08_28.tar.gz",
                   ckpt="vgg_19.ckpt"),
    "mobilenet_v1": dict(
        url=_TF_DL + "mobilenet_v1_2018_02_22/mobilenet_v1_1.0_224.tgz",
        ckpt="mobilenet_v1_1.0_224.ckpt"),
    "mobilenet_v2": dict(
        url=("https://storage.googleapis.com/mobilenet_v2/checkpoints/"
             "mobilenet_v2_1.0_224.tgz"),
        ckpt="mobilenet_v2_1.0_224.ckpt"),
    "mobilenet_v2_140": dict(  # net_params.py:85-90
        url=("https://storage.googleapis.com/mobilenet_v2/checkpoints/"
             "mobilenet_v2_1.4_224.tgz"),
        ckpt="mobilenet_v2_1.4_224.ckpt"),
}


def get_net_params(name: str, ckpt_dir_or_file: Optional[str] = None
                   ) -> Dict[str, str]:
    if name not in NET_PARAMS:
        raise ValueError(f"Unknown network: {name}")
    net = dict(NET_PARAMS[name], name=name)
    base = ckpt_dir_or_file or DEFAULT_CKPT_DIR
    if os.path.isfile(base):
        net["ckpt_path"] = base
    else:
        net["ckpt_path"] = os.path.join(base, net["ckpt"])
    net["converted_path"] = net["ckpt_path"] + ".msgpack"
    return net


def maybe_get_ckpt_file(net: Dict[str, str], allow_download: bool = False
                        ) -> Optional[str]:
    """Resolve (and convert) a pretrained checkpoint. Returns the converted
    msgpack path, or None when it is not on disk and downloading is off
    (the default); with a download, the reference's fetch and extract
    (common/utils.py:33-160)."""
    converted = net["converted_path"]
    if os.path.exists(converted):
        return converted
    ckpt = net["ckpt_path"]
    if not (os.path.exists(ckpt) or os.path.exists(ckpt + ".index")):
        if not allow_download:
            return None
        # atomic fetch + traversal-safe extract, shared with utils/io
        from .io import extract_archive, maybe_download

        tar_path = ckpt + ".tar.gz"
        maybe_download(net["url"], tar_path, allow_download=True)
        extract_archive(tar_path, os.path.dirname(ckpt))
        os.remove(tar_path)
    from .tf_checkpoint import convert_slim_checkpoint

    # prefer the registry's own name (ckpt basenames like
    # 'mobilenet_v2_1.0_224.ckpt' don't parse back to a net name)
    cnn_name = net.get("name")
    if not cnn_name:
        stem = os.path.basename(ckpt).split(".")[0]
        cnn_name = next((n for n in sorted(NET_PARAMS, key=len,
                                           reverse=True) if stem.startswith(n)),
                        stem)
    return convert_slim_checkpoint(ckpt, converted, cnn_name)

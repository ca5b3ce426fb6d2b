"""Orbax checkpoint directories, read and written with tensorstore alone
(``orbax.checkpoint`` imports JAX, which the port never does).

The layout is the one comic_tpu's ``OrbaxCheckpointer`` writes through
``StandardCheckpointHandler`` (orbax-checkpoint 0.11):
  - ``_METADATA``: JSON; ``tree_metadata`` maps each leaf's key path
    (``str`` of a tuple) to its keys, their kinds (1 a sequence index, 2 a
    dict key or attribute) and its value type (``np.ndarray``, ``scalar``,
    or ``None`` for an empty node such as ``optax.EmptyState`` or a masked
    leaf); ``use_ocdbt`` true, ``use_zarr3`` false;
  - one OCDBT key-value store over the directory (``manifest.ocdbt``,
    ``d/``) holding a zarr v2 array per leaf, named by its dot-joined key
    path (``params.encoder.cnn.Conv2d_1a_7x7.weights/``), in one chunk,
    zstd-compressed;
  - ``_CHECKPOINT_METADATA``: JSON naming the item handler and the commit
    time.

Trees cross in flax's state-dict layout, as the msgpack files hold them:
nested dicts, a sequence as a dict keyed "0".."n-1", an empty node as
``{}``. tensorstore is imported only inside the functions that need it.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from ..utils.optional import require

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
ITEM_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                "StandardCheckpointHandler")
_SEQUENCE, _DICT = 1, 2
# orbax's OCDBT settings for a checkpoint's store
_OCDBT_CONFIG = {"max_inline_value_bytes": 1024,
                 "max_decoded_node_bytes": 100000000,
                 "version_tree_arity_log2": 4,
                 "compression": {"id": "zstd"}}


def _tensorstore():
    return require("tensorstore", "An Orbax checkpoint")


def _array_spec(directory: str, name: str) -> Dict[str, Any]:
    """The zarr array of leaf ``name`` in the directory's OCDBT store."""
    return {"driver": "zarr",
            "kvstore": {"driver": "ocdbt",
                        "base": "file://" + os.path.abspath(directory),
                        "path": name + "/"}}


def read_tree(directory: str) -> Dict[str, Any]:
    """An Orbax directory -> its tree in flax's state-dict layout (numpy
    arrays; ``scalar`` leaves as numpy scalars; empty nodes as ``{}``).
    Raises FileNotFoundError, as orbax does, for a directory without
    ``_METADATA``."""
    path = os.path.join(directory, METADATA)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"No structure could be identified for the checkpoint at "
            f"{directory}: it has no {METADATA}.")
    with open(path) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(
            f"{directory}: not the layout comic_tpu's OrbaxCheckpointer "
            f"writes (use_ocdbt {meta.get('use_ocdbt')}, use_zarr3 "
            f"{meta.get('use_zarr3')})")
    ts = _tensorstore()
    context = ts.Context()
    entries: List[Tuple[List[str], str]] = []
    opened = []
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        kind = "None" if value.get("skip_deserialize") else \
            value["value_type"]
        entries.append((keys, kind))
        opened.append(None if kind == "None" else ts.open(
            _array_spec(directory, ".".join(keys)), open=True,
            context=context))
    reads = [None if o is None else o.result().read() for o in opened]
    tree: Dict[str, Any] = {}
    for (keys, kind), read in zip(entries, reads):
        if read is None:
            leaf: Any = {}
        else:
            leaf = np.asarray(read.result())
            if kind == "scalar":
                leaf = leaf[()]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def _leaves(tree: Dict[str, Any], prefix: Tuple[Tuple[str, int], ...] = ()
            ) -> List[Tuple[Tuple[Tuple[str, int], ...], Any]]:
    """(((key, kind), ...), leaf) of every leaf and empty node, in sorted
    key order (orbax's). A dict keyed exactly "0".."n-1" is a sequence."""
    keys = sorted(tree)
    kind = _SEQUENCE if keys and sorted(keys, key=lambda k: (
        len(k), k)) == [str(i) for i in range(len(keys))] else _DICT
    out = []
    for k in keys:
        v = tree[k]
        path = prefix + ((str(k), kind),)
        if isinstance(v, dict) and v:
            out.extend(_leaves(v, path))
        else:
            out.append((path, v))
    return out


def _value_type(leaf: Any) -> str:
    if isinstance(leaf, dict):
        return "None"
    if isinstance(leaf, (bool, int, float, np.generic)):
        return "scalar"
    return "np.ndarray"


def write_tree(directory: str, tree: Dict[str, Any]) -> str:
    """Write ``tree`` (flax's state-dict layout: dicts of numpy arrays,
    numpy or Python scalars, ``{}`` for empty nodes) as an Orbax directory
    that ``orbax.checkpoint.StandardCheckpointer().restore`` reads back.
    The directory is built under a temporary name and renamed into place
    (an existing one is replaced); returns its path."""
    ts = _tensorstore()
    directory = os.path.abspath(directory)
    started = time.time_ns()
    tmp = f"{directory}.{os.getpid()}.{threading.get_ident()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    context = ts.Context()
    # one transaction: the store commits once, not once per leaf
    txn = ts.Transaction()
    tree_metadata = {}
    writes = []
    for path, leaf in _leaves(tree):
        keys = tuple(k for k, _ in path)
        value_type = _value_type(leaf)
        tree_metadata[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": kind}
                             for k, kind in path],
            "value_metadata": {"value_type": value_type,
                               "skip_deserialize": value_type == "None"}}
        if value_type == "None":
            continue
        arr = np.asarray(leaf)
        spec = _array_spec(tmp, ".".join(keys))
        spec["kvstore"]["config"] = _OCDBT_CONFIG
        spec["metadata"] = {
            "shape": list(arr.shape), "chunks": list(arr.shape),
            "dtype": arr.dtype.str, "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "fill_value": None, "order": "C",
            "filters": None}
        writes.append((ts.open(spec, create=True, context=context,
                               transaction=txn), arr))
    for done in [store.result().write(arr) for store, arr in writes]:
        done.result()
    txn.commit_async().result()
    with open(os.path.join(tmp, METADATA), "w") as f:
        json.dump({"tree_metadata": tree_metadata, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": ITEM_HANDLER, "metrics": {},
                   "performance_metrics": {},
                   "init_timestamp_nsecs": started,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    if os.path.isdir(directory):
        shutil.rmtree(directory)
    os.replace(tmp, directory)
    return directory

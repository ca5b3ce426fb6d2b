"""NASNet-A and PNASNet-5 image encoders, counterpart of
comic_tpu/models/nasnet.py (slim nasnet/{nasnet,nasnet_utils,pnasnet}.py).
Four variants: nasnet_mobile, nasnet_large, pnasnet_mobile, pnasnet_large.

The cell program is data: each cell combines 5 pairs of hidden states with
predicted operations (stacked separable convs, 3x3 pools, identity) and
concatenates the unused states (nasnet_utils.py:246-421). Which layers a
cell holds depends on the shapes that reach it, so parameters are managed
by a scope-path store: ``init_params`` runs the forward once on the "meta"
device (shapes only, no arithmetic) to collect the (path, shape, kind) of
every variable, then draws them; ``apply`` runs the same forward fetching
the parameters by path. The paths are comic_tpu's leaf for leaf, the
compound leaf keys included (cell_stem_0/comb_iter_0/left/
"separable_5x5_1/depthwise_weights", "conv0/weights"), since slim
checkpoints and the weight bridge key on them. Shapes are declared in
comic_tpu's layout and the tensors held in the port's (params.py).

Slim semantics (imagenet stem, output stride 32):
  - stem: 3x3/2 VALID conv (32 * stem_multiplier) + BN, then two stride-2
    stem cells at filter scalings 1/rate^2 and 1/rate; nasnet's stem cells
    are its reduction cell, pnasnet's its normal cell;
  - reductions at calc_reduction_layers(num_cells, 2); the cell after a
    reduction sees the pre-reduction layer when skip_reduction_layer_input;
  - a separable op is relu -> separable conv -> BN, stacked twice, stride
    on the first; pools are 3x3 SAME (average divided by the in-bounds
    count); 'none' adds a strided 1x1 conv + BN only where the shape must
    change;
  - the factorized reduction concatenates two half-width 1x1 convs over
    subsampled paths, the second shifted one pixel, then BN;
  - BN scale=True, eps 1e-3, inference mode always; drop-path does nothing
    at inference and is left out, as in comic_tpu;
  - the pooled feature is the global average after a final relu.

Inception preprocessing; default image sizes 224 (mobile) / 331 (large).
Feature maps are NCHW.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import params as bridge
from . import layers

Params = Dict[str, Any]

BN_EPS = 1e-3


class NasNetConfig(NamedTuple):
    num_cells: int
    num_conv_filters: int
    stem_multiplier: float
    filter_scaling_rate: float = 2.0
    num_reduction_layers: int = 2
    skip_reduction_layer_input: bool = False
    is_pnasnet: bool = False


CONFIGS: Dict[str, NasNetConfig] = {
    # nasnet.py:69-113, pnasnet.py:34-67
    "nasnet_mobile": NasNetConfig(12, 44, 1.0),
    "nasnet_large": NasNetConfig(18, 168, 3.0,
                                 skip_reduction_layer_input=True),
    "pnasnet_mobile": NasNetConfig(9, 54, 1.0,
                                   skip_reduction_layer_input=True,
                                   is_pnasnet=True),
    "pnasnet_large": NasNetConfig(12, 216, 3.0,
                                  skip_reduction_layer_input=True,
                                  is_pnasnet=True),
}

DEFAULT_IMAGE_SIZES = {"nasnet_mobile": 224, "nasnet_large": 331,
                       "pnasnet_mobile": 224, "pnasnet_large": 331}
FEATURE_DIMS = {"nasnet_mobile": 1056, "nasnet_large": 4032,
                "pnasnet_mobile": 1080, "pnasnet_large": 4320}

# cell programs: (operations, used_hiddenstates, hiddenstate_indices)
# nasnet_utils.py:475-524, pnasnet.py:263-280
NORMAL_CELL = (
    ["separable_5x5_2", "separable_3x3_2", "separable_5x5_2",
     "separable_3x3_2", "avg_pool_3x3", "none", "avg_pool_3x3",
     "avg_pool_3x3", "separable_3x3_2", "none"],
    [1, 0, 0, 0, 0, 0, 0],
    [0, 1, 1, 1, 0, 1, 1, 1, 0, 0],
)
REDUCTION_CELL = (
    ["separable_5x5_2", "separable_7x7_2", "max_pool_3x3",
     "separable_7x7_2", "avg_pool_3x3", "separable_5x5_2", "none",
     "avg_pool_3x3", "separable_3x3_2", "max_pool_3x3"],
    [1, 1, 1, 0, 0, 0, 0],
    [0, 1, 0, 1, 0, 1, 3, 2, 2, 0],
)
PNAS_NORMAL_CELL = (
    ["separable_5x5_2", "max_pool_3x3", "separable_7x7_2", "max_pool_3x3",
     "separable_5x5_2", "separable_3x3_2", "separable_3x3_2",
     "max_pool_3x3", "separable_3x3_2", "none"],
    [1, 1, 0, 0, 0, 0, 0],
    [1, 1, 0, 0, 0, 0, 4, 0, 1, 0],
)


# --------------------------------------------------------------------------
# Scope-path parameter store
# --------------------------------------------------------------------------

class _Store:
    """Collects (shape pass, ``params`` None) or fetches (apply pass)
    parameters by scope path."""

    def __init__(self, params: Optional[Params] = None):
        self.params = params
        self.specs: List[Tuple[Tuple[str, ...], Tuple[int, ...], str]] = []
        self._scope: List[str] = []

    @contextlib.contextmanager
    def scope(self, name: str):
        self._scope.append(name)
        try:
            yield
        finally:
            self._scope.pop()

    def var(self, name: str, shape: Tuple[int, ...], kind: str
            ) -> torch.Tensor:
        """The variable ``name`` under the current scope; ``shape`` is in
        comic_tpu's layout, the tensor in the port's."""
        path = tuple(self._scope) + (name,)
        if self.params is not None:
            node = self.params
            for p in path:
                node = node[p]
            return node
        self.specs.append((path, tuple(shape), kind))
        return bridge.port_layout(name, torch.zeros(shape, device="meta"))


def _materialize(generator: torch.Generator, specs) -> Params:
    params: Params = {}
    for path, shape, kind in specs:
        if kind == "conv":
            # variance scaling FAN_OUT, truncated normal (the arg scopes)
            arr = layers.slim_variance_scaling(
                generator, shape, shape[0] * shape[1] * shape[3])
        elif kind == "ones":
            arr = torch.ones(shape)
        else:
            arr = torch.zeros(shape)
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = bridge.port_layout(path[-1], arr)
    return params


# --------------------------------------------------------------------------
# Primitive ops
# --------------------------------------------------------------------------

def _conv(store, name, x, cout, k=1, stride=1, padding="SAME", dtype=None):
    w = store.var(f"{name}/weights", (k, k, x.shape[1], cout), "conv")
    return layers.conv_f32(x, w, stride, padding, dtype)


def _bn(store, name, x):
    c = x.shape[1]
    bn = {"gamma": store.var(f"{name}/gamma", (c,), "ones"),
          "beta": store.var(f"{name}/beta", (c,), "zeros"),
          "moving_mean": store.var(f"{name}/moving_mean", (c,), "zeros"),
          "moving_variance": store.var(f"{name}/moving_variance", (c,),
                                       "ones")}
    return layers.frozen_bn(x, bn, BN_EPS)


def _sep_conv(store, name, x, cout, k, stride, dtype=None):
    """slim.separable_conv2d, depth multiplier 1: depthwise, then pointwise
    (each in the compute dtype with a float32 result)."""
    cin = x.shape[1]
    dw = store.var(f"{name}/depthwise_weights", (k, k, cin, 1), "conv")
    pw = store.var(f"{name}/pointwise_weights", (1, 1, cin, cout), "conv")
    y = layers.conv_f32(x, layers.depthwise_kernel(dw), stride, "SAME",
                        dtype, groups=cin)
    return layers.conv_f32(y, pw, 1, "SAME", dtype)


def _stacked_separable(store, x, op, filters, stride, dtype):
    """relu -> separable conv -> BN, twice, stride on the first
    (nasnet_utils.py:178-206)."""
    k = int(op.split("x")[0][-1])
    last = op.split("_")[-1]
    repeats = int(last) if "x" not in last else 1
    for i in range(1, repeats + 1):
        x = _sep_conv(store, f"separable_{k}x{k}_{i}", torch.relu(x),
                      filters, k, stride, dtype)
        x = _bn(store, f"bn_sep_{k}x{k}_{i}", x)
        stride = 1
    return x


def _factorized_reduction(store, x, out_filters, stride, dtype):
    """nasnet_utils.py:90-129: at stride 2, two half-width 1x1 convs over
    x subsampled, and over x shifted one pixel up and left (zero pad after)
    and subsampled, concatenated, then BN."""
    if stride == 1:
        y = _conv(store, "path_conv", x, out_filters, 1, dtype=dtype)
        return _bn(store, "path_bn", y)
    p1 = _conv(store, "path1_conv", x[:, :, ::stride, ::stride],
               out_filters // 2, 1, dtype=dtype)
    p2 = F.pad(x, (0, 1, 0, 1))[:, :, 1:, 1:][:, :, ::stride, ::stride]
    p2 = _conv(store, "path2_conv", p2, out_filters // 2 + out_filters % 2,
               1, dtype=dtype)
    return _bn(store, "final_path_bn", torch.cat([p1, p2], dim=1))


def _apply_conv_op(store, x, op, filters, stride, from_original, dtype):
    """nasnet_utils.py:357-394 (no drop path: an inference build)."""
    if stride > 1 and not from_original:
        stride = 1
    cin = x.shape[1]
    if "separable" in op:
        return _stacked_separable(store, x, op, filters, stride, dtype)
    if op == "none":
        if stride > 1 or cin != filters:
            x = _conv(store, "1x1", torch.relu(x), filters, 1, stride,
                      dtype=dtype)
            x = _bn(store, "bn_1", x)
        return x
    if "pool" in op:
        k = int(op.split("_")[-1].split("x")[0])
        x = (layers.avg_pool(x, k, stride) if op.startswith("avg")
             else layers.max_pool(x, k, stride))
        if cin != filters:
            x = _conv(store, "1x1", x, filters, 1, 1, dtype=dtype)
            x = _bn(store, "bn_1", x)
        return x
    raise ValueError(f"Unimplemented operation {op}")


def _cell(store, scope, program, net, prev, filters, stride, dtype):
    """One NASNet-A cell (nasnet_utils.py:295-421)."""
    ops, used, indices = program
    with store.scope(scope):
        # _reduce_prev_layer
        if prev is None:
            prev = net
        elif prev.shape[3] != net.shape[3]:
            prev = _factorized_reduction(store, torch.relu(prev), filters, 2,
                                         dtype)
        elif prev.shape[1] != filters:
            prev = _conv(store, "prev_1x1", torch.relu(prev), filters, 1,
                         dtype=dtype)
            prev = _bn(store, "prev_bn", prev)
        # _cell_base
        h = _conv(store, "1x1", torch.relu(net), filters, 1, dtype=dtype)
        h = _bn(store, "beginning_bn", h)
        states = [h, prev]

        for it in range(5):
            with store.scope(f"comb_iter_{it}"):
                li, ri = indices[2 * it], indices[2 * it + 1]
                with store.scope("left"):
                    h1 = _apply_conv_op(store, states[li], ops[2 * it],
                                        filters, stride, li < 2, dtype)
                with store.scope("right"):
                    h2 = _apply_conv_op(store, states[ri], ops[2 * it + 1],
                                        filters, stride, ri < 2, dtype)
                states.append(h1 + h2)

        # _combine_unused_states
        with store.scope("cell_output"):
            final = states[-1]
            outs = []
            for idx, (s, is_used) in enumerate(zip(states, used)):
                if is_used:
                    continue
                if (s.shape[3] != final.shape[3]
                        or s.shape[1] != final.shape[1]):
                    st = 2 if s.shape[3] != final.shape[3] else 1
                    with store.scope(f"reduction_{idx}"):
                        s = _factorized_reduction(store, s, final.shape[1],
                                                  st, dtype)
                outs.append(s)
            return torch.cat(outs, dim=1)


# --------------------------------------------------------------------------
# Full networks
# --------------------------------------------------------------------------

def _reduction_indices(num_cells: int, num_reductions: int) -> List[int]:
    return [int(float(p) / (num_reductions + 1) * num_cells)
            for p in range(1, num_reductions + 1)]


def _forward(store: _Store, images: torch.Tensor, cfg: NasNetConfig,
             final_endpoint: Optional[str], dtype):
    ep: Dict[str, torch.Tensor] = {}

    def done(name, net):
        ep[name] = net
        return name == final_endpoint

    rate = cfg.filter_scaling_rate
    normal = PNAS_NORMAL_CELL if cfg.is_pnasnet else NORMAL_CELL
    stem_cell = PNAS_NORMAL_CELL if cfg.is_pnasnet else REDUCTION_CELL

    # imagenet stem (nasnet.py:252-278)
    net = _conv(store, "conv0", images, int(32 * cfg.stem_multiplier), 3, 2,
                "VALID", dtype)
    net = _bn(store, "conv0_bn", net)
    outputs: List[Optional[torch.Tensor]] = [None, net]
    scaling = 1.0 / (rate ** 2)
    for i in range(2):
        net = _cell(store, f"cell_stem_{i}", stem_cell, net, outputs[-2],
                    int(cfg.num_conv_filters * scaling), 2, dtype)
        outputs.append(net)
        scaling *= rate
    if done("Stem", net):
        return net, ep

    reductions = _reduction_indices(cfg.num_cells, cfg.num_reduction_layers)
    scaling = 1.0
    prev = None
    for cell_num in range(cfg.num_cells):
        is_red = cell_num in reductions
        if cfg.is_pnasnet:
            # pnasnet.py:120-137: a stride-2 normal cell at reductions
            if is_red:
                scaling *= rate
            if cfg.skip_reduction_layer_input or not is_red:
                prev = outputs[-2]
            net = _cell(store, f"cell_{cell_num}", normal, net, prev,
                        int(cfg.num_conv_filters * scaling),
                        2 if is_red else 1, dtype)
            if done(f"Cell_{cell_num}", net):
                return net, ep
            outputs.append(net)
            continue
        # nasnet.py:491-527
        if cfg.skip_reduction_layer_input:
            prev = outputs[-2]
        if is_red:
            scaling *= rate
            ridx = reductions.index(cell_num)
            net = _cell(store, f"reduction_cell_{ridx}", REDUCTION_CELL,
                        net, outputs[-2],
                        int(cfg.num_conv_filters * scaling), 2, dtype)
            if done(f"Reduction_Cell_{ridx}", net):
                return net, ep
            outputs.append(net)
        if not cfg.skip_reduction_layer_input:
            prev = outputs[-2]
        net = _cell(store, f"cell_{cell_num}", normal, net, prev,
                    int(cfg.num_conv_filters * scaling), 1, dtype)
        if done(f"Cell_{cell_num}", net):
            return net, ep
        outputs.append(net)

    net = torch.relu(net)
    done("final_relu", net)
    return net, ep


def init_params(generator: torch.Generator, name: str = "nasnet_mobile",
                image_size: Optional[int] = None) -> Params:
    """Run the forward on the meta device to collect every variable, then
    draw them on the CPU."""
    size = image_size or DEFAULT_IMAGE_SIZES[name]
    store = _Store()
    _forward(store, torch.zeros((1, 3, size, size), device="meta"),
             CONFIGS[name], None, None)
    return _materialize(generator, store.specs)


def apply(params: Params, images: torch.Tensor,
          name: str = "nasnet_mobile",
          final_endpoint: Optional[str] = None,
          dtype: Optional[torch.dtype] = None,
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, 3, H, W) in [-1, 1] -> (net, end_points), float32 NCHW."""
    return _forward(_Store(params), images, CONFIGS[name], final_endpoint,
                    dtype)


def pooled_features(net: torch.Tensor) -> torch.Tensor:
    """The relu is already applied: the global average pool."""
    return net.mean(dim=(2, 3))

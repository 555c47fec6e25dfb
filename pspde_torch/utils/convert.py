"""Flax parameter trees -> the port's modules.

A Flax parameter tree arrives as nested dicts of numpy arrays, e.g. the
``TanhMLP`` control

    {'params': {'Dense_0': {'kernel': (in, out), 'bias': (out,)}, ...}}

A Flax ``Dense`` kernel is (in, out); an ``nn.Linear.weight`` is (out, in),
so kernels are transposed on the way in.  The ``DenseNet`` value net has
the same tree, with layer i's kernel (d_in + sum(arch[:i]), arch[i]).
The other concat-skip nets (``DenseNetTanh``, ``DenseNetTanh2``,
``DenseNetRelu``) and ``ReluMLP1d`` have the same tree; ``BatchNormMLP``'s
Dense_i have a kernel only, beside its bn_scale_i and bn_bias_i; ``Sines``
has {'alpha'}, ``ConstantVector`` {'c'}, ``Affine`` {'A', 'b'}.  Modules
are built on ``device=``, the CUDA card when None (``utils/device.py``).
``eigen_params_from_flax`` carries the eigen solver's {'V': concat-skip
tree, 'lam': ScalarParam tree}.  The LQ controls ``LinearLQ`` and
``LinearLQTime`` have one leaf, {'params': {'F': ...}}.
``flax_state_dict`` maps a tree to the ``state_dict()`` of a given module
of any of these kinds, also for trees stacked on a leading axis (the HJB
solver's 'outer' time approximation, one parameter set per step).
``load_control_npz`` reads the exported control asset
(``experiments/export_llgc_control.py``): the flat tree under '/'-joined
keys plus a JSON metadata string under ``__meta__``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..ansatz import (Affine, BatchNormMLP, ConcatSkipNet, ConstantVector,
                      DenseNet, LinearLQ, LinearLQTime, ReluMLP1d,
                      ScalarParam, Sines, TanhMLP)


def unflatten_tree(flat: dict) -> dict:
    """{'a/b/c': array} -> {'a': {'b': {'c': array}}}."""
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """{'a': {'b': {'c': array}}} -> {'a/b/c': float32 array}, the flat
    tree the assets hold (``unflatten_tree``'s inverse)."""
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            flat.update(flatten_tree(val, name))
        else:
            flat[name] = np.asarray(val, dtype=np.float32)
    return flat


def _dense_layers(tree: dict):
    """The ordered (kernel, bias) pairs of a Flax MLP parameter tree."""
    params = tree["params"] if "params" in tree else tree
    names = sorted((k for k in params if k.startswith("Dense_")),
                   key=lambda k: int(k.split("_")[1]))
    if not names or len(names) != len(params):
        raise ValueError("expected a tree of Dense_i layers, got keys "
                         f"{sorted(params)}")
    return [(np.asarray(params[n]["kernel"], dtype=np.float32),
             np.asarray(params[n]["bias"], dtype=np.float32)) for n in names]


def tanh_mlp_state_dict(tree: dict) -> dict:
    """Flax TanhMLP (or DenseNet) tree -> the module's ``state_dict()``
    (kernels transposed; a leading stack axis is kept)."""
    state = {}
    for i, (kernel, bias) in enumerate(_dense_layers(tree)):
        state[f"layers.{i}.weight"] = torch.tensor(
            np.ascontiguousarray(np.swapaxes(kernel, -1, -2)))
        state[f"layers.{i}.bias"] = torch.tensor(bias)
    return state


def tanh_mlp_from_flax(tree: dict, device=None) -> TanhMLP:
    """Build a ``TanhMLP`` whose widths are read off the Flax tree and load
    its parameters."""
    layers = _dense_layers(tree)
    widths = [k.shape[0] for k, _ in layers] + [layers[-1][0].shape[1]]
    net = TanhMLP(widths[0], widths[-1], hidden=widths[1:-1], device=device)
    net.load_state_dict(tanh_mlp_state_dict(tree))
    return net


def tanh_mlp_to_flax(tensors) -> dict:
    """The inverse direction, for parameters or their gradients: the
    tensors of ``TanhMLP.parameters()`` (or ``DenseNet.parameters()``)
    order (weight (out, in), bias per layer) -> a Flax tree of numpy
    arrays, kernels transposed to (in, out), so a test can compare leaf by
    leaf."""
    tensors = [t.detach().cpu().numpy() for t in tensors]
    return {"params": {f"Dense_{i}": {"kernel": np.ascontiguousarray(W.T),
                                       "bias": b}
                       for i, (W, b) in enumerate(zip(tensors[::2],
                                                      tensors[1::2]))}}


def dense_net_from_flax(tree: dict, output_relu: bool = False,
                        device=None, cls=DenseNet) -> ConcatSkipNet:
    """Build a concat-skip net of class ``cls`` (``DenseNet``, or
    ``DenseNetTanh``, ``DenseNetTanh2``, ``DenseNetRelu``) whose d_in, arch
    and d_out are read off the Flax tree and load its parameters
    (``output_relu`` is not in the tree: pass the Flax module's)."""
    layers = _dense_layers(tree)
    d_in = layers[0][0].shape[0]
    arch = tuple(k.shape[1] for k, _ in layers[:-1])
    for i, (k, _) in enumerate(layers):
        if k.shape[0] != d_in + sum(arch[:i]):
            raise ValueError(f"Dense_{i} kernel {k.shape} is not a "
                             f"concat-skip layer of d_in={d_in}, arch={arch}")
    clamp = {"output_relu": True} if output_relu else {}
    net = cls(d_out=layers[-1][0].shape[1], arch=arch, d_in=d_in,
              device=device, **clamp)
    net.load_state_dict(tanh_mlp_state_dict(tree))
    return net


dense_net_to_flax = tanh_mlp_to_flax


def eigen_params_from_flax(tree: dict, output_relu: bool = False,
                           device=None, cls=DenseNet):
    """The eigen solver's tree {'V': <Flax concat-skip net>, 'lam':
    <ScalarParam>} -> (the net of class ``cls``, ScalarParam)."""
    return (dense_net_from_flax(tree["V"], output_relu=output_relu,
                                device=device, cls=cls),
            scalar_param_from_flax(tree["lam"], device=device))


def eigen_params_to_flax(v_tensors, lam) -> dict:
    """The inverse direction, for parameters or their gradients: the
    DenseNet's tensors (``parameters()`` order) and lambda's -> the eigen
    solver's tree of numpy arrays."""
    return {"V": dense_net_to_flax(v_tensors),
            "lam": {"params": {"Y_0": lam.detach().cpu().numpy().reshape(
                1)}}}


def _lq_F(tree: dict) -> np.ndarray:
    params = tree["params"] if "params" in tree else tree
    if sorted(params) != ["F"]:
        raise ValueError(f"expected an LQ control tree {{'F': ...}}, got "
                         f"keys {sorted(params)}")
    return np.asarray(params["F"], dtype=np.float32)


def linear_lq_from_flax(tree: dict, B, Q, device=None) -> LinearLQ:
    """Build a ``LinearLQ`` for the matrices ``B``, ``Q`` and load F."""
    net = LinearLQ(B, Q, init_scale=0.0, device=device)
    net.load_state_dict(flax_state_dict(net, tree))
    return net


def linear_lq_time_from_flax(tree: dict, B, Q, T, device=None
                             ) -> LinearLQTime:
    """Build a ``LinearLQTime`` whose degree is read off F's shape and
    load F."""
    net = LinearLQTime(B, Q, T, degree=_lq_F(tree).shape[0] - 1,
                       device=device)
    net.load_state_dict(flax_state_dict(net, tree))
    return net


def _leaves(tree: dict, names) -> dict:
    """The named leaves of a Flax tree as float32 tensors; raises on other
    keys."""
    params = tree["params"] if "params" in tree else tree
    if sorted(params) != sorted(names):
        raise ValueError(f"expected a tree of {sorted(names)}, got keys "
                         f"{sorted(params)}")
    return {k: torch.tensor(np.asarray(params[k], dtype=np.float32))
            for k in names}


def _batch_norm_state(module, tree: dict) -> dict:
    """BatchNormMLP: Dense_i's kernel (no bias) transposed into
    layers.i.weight, the bn_scale_i / bn_bias_i leaves under their own
    names."""
    params = tree["params"] if "params" in tree else tree
    n_bn = len(module.layers) + 1
    names = ([f"Dense_{i}" for i in range(len(module.layers))]
             + [f"bn_{k}_{i}" for i in range(n_bn)
                for k in ("scale", "bias")])
    if sorted(params) != sorted(names):
        raise ValueError(f"expected a BatchNormMLP tree of {sorted(names)}, "
                         f"got keys {sorted(params)}")
    state = {}
    for i in range(len(module.layers)):
        kernel = np.asarray(params[f"Dense_{i}"]["kernel"], dtype=np.float32)
        state[f"layers.{i}.weight"] = torch.tensor(
            np.ascontiguousarray(np.swapaxes(kernel, -1, -2)))
    for name in names[len(module.layers):]:
        state[name] = torch.tensor(np.asarray(params[name],
                                              dtype=np.float32))
    return state


def flax_state_dict(module, tree: dict) -> dict:
    """A Flax tree of the kind of ``module`` (TanhMLP, any concat-skip net,
    ReluMLP1d, BatchNormMLP, Sines, ConstantVector, Affine, LinearLQ,
    LinearLQTime) -> ``module.state_dict()``'s parameters (its buffers are
    not in the tree and are kept); leaves stacked on a leading axis stay
    stacked.  Also maps a tree of gradients to the parameters' names."""
    if isinstance(module, (TanhMLP, ConcatSkipNet, ReluMLP1d)):
        return tanh_mlp_state_dict(tree)
    if isinstance(module, BatchNormMLP):
        return _batch_norm_state(module, tree)
    if isinstance(module, (LinearLQ, LinearLQTime)):
        state = {k: v for k, v in module.state_dict().items() if k != "F"}
        state["F"] = torch.tensor(_lq_F(tree))
        return state
    leaf = {Sines: ("alpha",), ConstantVector: ("c",),
            Affine: ("A", "b")}.get(type(module))
    if leaf is None:
        raise ValueError(f"no Flax converter for {type(module).__name__}")
    state = dict(module.state_dict())
    state.update(_leaves(tree, leaf))
    return state


def scalar_param_from_flax(tree: dict, device=None) -> ScalarParam:
    params = tree["params"] if "params" in tree else tree
    mod = ScalarParam(initial=0.0, device=device)
    with torch.no_grad():
        mod.Y_0.copy_(torch.tensor(
            np.asarray(params["Y_0"], dtype=np.float32).reshape(1)))
    return mod


def load_control_npz(path: str):
    """Read an exported control asset -> (param tree, metadata dict)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(str(z["__meta__"])) if "__meta__" in z.files else {}
    return unflatten_tree(flat), meta

from .device import resolve_device, solver_device
from .schedule import cosine_decay_schedule

_CONVERT = ("dense_net_from_flax", "dense_net_to_flax",
            "eigen_params_from_flax", "eigen_params_to_flax",
            "load_control_npz", "scalar_param_from_flax",
            "tanh_mlp_from_flax", "tanh_mlp_state_dict", "tanh_mlp_to_flax",
            "unflatten_tree")

__all__ = sorted(_CONVERT + ("cosine_decay_schedule", "resolve_device",
                             "solver_device"))


def __getattr__(name):
    # the converters import the ansatz modules, which import
    # utils/device.py: load them on first use, not with this package
    if name in _CONVERT:
        from . import convert
        return getattr(convert, name)
    raise AttributeError(name)

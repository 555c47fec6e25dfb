from .convert import (load_control_npz, scalar_param_from_flax,
                      tanh_mlp_from_flax, tanh_mlp_state_dict, unflatten_tree)

__all__ = ["load_control_npz", "scalar_param_from_flax", "tanh_mlp_from_flax",
           "tanh_mlp_state_dict", "unflatten_tree"]

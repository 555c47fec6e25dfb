from .convert import (load_control_npz, scalar_param_from_flax,
                      tanh_mlp_from_flax, tanh_mlp_state_dict,
                      tanh_mlp_to_flax, unflatten_tree)

__all__ = ["load_control_npz", "scalar_param_from_flax", "tanh_mlp_from_flax",
           "tanh_mlp_state_dict", "tanh_mlp_to_flax", "unflatten_tree"]

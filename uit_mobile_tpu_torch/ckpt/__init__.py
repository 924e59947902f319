from .artifact import export_serving, load_artifact, save_artifact
from .convert import module_from_numpy, module_to_numpy
from .io import (average_checkpoints, config_from_dict, config_to_dict, load_checkpoint,
                 load_model, load_pretrained_partial, load_training_state, retarget_pos_embeds,
                 save_checkpoint, save_numpy_checkpoint, save_training_state)
from .torch_convert import (load_torch_checkpoint, mobilenetv2_params_from_torch_state_dict,
                            uit_params_from_torch_state_dict)

__all__ = [
    "average_checkpoints",
    "config_from_dict",
    "config_to_dict",
    "export_serving",
    "load_artifact",
    "load_checkpoint",
    "load_model",
    "load_pretrained_partial",
    "load_torch_checkpoint",
    "load_training_state",
    "mobilenetv2_params_from_torch_state_dict",
    "module_from_numpy",
    "module_to_numpy",
    "retarget_pos_embeds",
    "save_artifact",
    "save_checkpoint",
    "save_numpy_checkpoint",
    "save_training_state",
    "uit_params_from_torch_state_dict",
]

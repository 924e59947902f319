from .convert import module_from_numpy, module_to_numpy
from .io import (average_checkpoints, config_from_dict, config_to_dict, load_checkpoint,
                 load_model, load_pretrained_partial, load_training_state, retarget_pos_embeds,
                 save_checkpoint, save_numpy_checkpoint, save_training_state)

__all__ = [
    "average_checkpoints",
    "config_from_dict",
    "config_to_dict",
    "load_checkpoint",
    "load_model",
    "load_pretrained_partial",
    "load_training_state",
    "module_from_numpy",
    "module_to_numpy",
    "retarget_pos_embeds",
    "save_checkpoint",
    "save_numpy_checkpoint",
    "save_training_state",
]

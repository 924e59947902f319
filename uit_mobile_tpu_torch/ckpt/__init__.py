from .convert import module_from_numpy, module_to_numpy
from .io import (config_from_dict, config_to_dict, load_checkpoint, load_model,
                 save_checkpoint)

__all__ = [
    "config_from_dict",
    "config_to_dict",
    "load_checkpoint",
    "load_model",
    "module_from_numpy",
    "module_to_numpy",
    "save_checkpoint",
]

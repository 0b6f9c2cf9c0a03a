"""The LM stack of the port (`repro/models/`): configuration, parameter
specs, layers, the decoder LM and whisper."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.common import (ParamSpec, abstract_params,
                                       init_params, params_from_numpy,
                                       tree_size)

__all__ = ["ModelConfig", "ParamSpec", "init_params", "abstract_params",
           "params_from_numpy", "tree_size"]

from qtpu_torch.transform.calibrate import calibrate
from qtpu_torch.transform.convert import (convert_model, deep_merge,
                                          quant_state, quantize_variables,
                                          set_mode, strip_quant)
from qtpu_torch.transform.freeze import freeze

__all__ = ["calibrate", "convert_model", "deep_merge", "freeze",
           "quant_state", "quantize_variables", "set_mode", "strip_quant"]

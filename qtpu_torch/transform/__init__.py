from qtpu_torch.transform.calibrate import calibrate
from qtpu_torch.transform.freeze import freeze

__all__ = ["calibrate", "freeze"]

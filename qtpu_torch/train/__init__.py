"""Training loops (fp32 + QAT/STE) and evaluation."""
from qtpu_torch.train.loop import (TrainState, adamw, create_train_state,
                                   cross_entropy, eval_step, evaluate, fit,
                                   train_step)

__all__ = ["TrainState", "adamw", "create_train_state", "cross_entropy",
           "eval_step", "evaluate", "fit", "train_step"]

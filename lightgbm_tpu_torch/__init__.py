"""lightgbm_tpu_torch: the PyTorch / CUDA port of lightgbm_tpu.

LightGBM's training API (Dataset, Booster, train and its callbacks) on
torch tensors; the histogram, partition, take and segment-sum passes of
training run as hand-written CUDA kernels for the NVIDIA H100
(learner/cuda_hist.py, csrc/). Entry points run on the card unless
device_type=cpu is passed, which selects the kernels' plain PyTorch
versions. Booster.predict(X, device="cuda") and the serving package
(serving.ModelRegistry, the bucketed dispatcher's CUDA graphs, the
JSON-lines and HTTP servers) score trained models on the card. The
package imports neither jax nor lightgbm_tpu.
"""

from .basic import Booster, Dataset
from .callback import (
    CallbackEnv,
    EarlyStopException,
    early_stopping,
    log_evaluation,
    record_evaluation,
    reset_parameter,
)
from .engine import train
from .log import LightGBMError
from . import serving

__all__ = ["Booster", "CallbackEnv", "Dataset", "EarlyStopException",
           "LightGBMError", "early_stopping", "log_evaluation",
           "record_evaluation", "reset_parameter", "serving", "train"]

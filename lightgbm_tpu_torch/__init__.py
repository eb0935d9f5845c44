"""lightgbm_tpu_torch: the PyTorch / CUDA port of lightgbm_tpu.

LightGBM's Python API on torch tensors: Dataset (dense, pandas, Arrow,
scipy sparse, text and binary file inputs; Sequence, two_round and
data_source=chunked inputs larger than host RAM through the data plane,
data/), Booster, train, cv and its
CVBooster, the callbacks, and the scikit-learn estimators (which need
scikit-learn, as in the JAX package). The histogram, partition, take and
segment-sum passes of training run as hand-written CUDA kernels for the
NVIDIA H100 (learner/cuda_hist.py, csrc/). Entry points run on the card
unless device_type=cpu is passed, which selects the kernels' plain
PyTorch versions. Booster.predict(X, device="cuda") and the serving
package (serving.ModelRegistry, the bucketed dispatcher's CUDA graphs, the
JSON-lines and HTTP servers) score trained models on the card. The
package imports neither jax nor lightgbm_tpu.

The online train-and-serve loop (online/), the serving gateway
(serving.Gateway) and the plots (plot_importance, plot_metric, plot_tree,
plot_split_value_histogram, create_tree_digraph; they need matplotlib)
are here too, and the distributed learners (tree_learner=data / voting /
feature over torch.distributed ranks, parallel/; set_network,
run_distributed, the Dask* estimators of dask.py). NOT_PORTED, the names
of the JAX package not ported yet, is empty.
"""

from .basic import Booster, Dataset, Sequence, set_network
from .callback import (
    CallbackEnv,
    EarlyStopException,
    early_stopping,
    log_evaluation,
    record_evaluation,
    reset_parameter,
)
from .engine import CVBooster, cv, train
from .log import LightGBMError, register_logger
from .plotting import (
    create_tree_digraph,
    plot_importance,
    plot_metric,
    plot_split_value_histogram,
    plot_tree,
)
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
from .dask import DaskLGBMClassifier, DaskLGBMRanker, DaskLGBMRegressor
from . import data, serving

__version__ = "0.1.0"

# public names of the JAX package the port does not implement yet, with
# the ROADMAP item that ports each: none are left
NOT_PORTED: dict = {}

__all__ = ["Booster", "CVBooster", "CallbackEnv", "Dataset",
           "EarlyStopException", "LGBMClassifier", "LGBMModel", "LGBMRanker",
           "LGBMRegressor", "LightGBMError", "Sequence", "cv",
           "early_stopping", "log_evaluation", "record_evaluation",
           "register_logger", "reset_parameter", "data", "serving",
           "set_network",
           "train", "DaskLGBMClassifier", "DaskLGBMRegressor",
           "DaskLGBMRanker", "plot_importance", "plot_split_value_histogram",
           "plot_metric", "plot_tree", "create_tree_digraph", "__version__"]

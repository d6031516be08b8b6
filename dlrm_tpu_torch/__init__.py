"""dlrm_tpu_torch — the PyTorch/CUDA port of ``dlrm_tpu`` for one NVIDIA
H100.

It mirrors ``dlrm_tpu``'s module layout and names.  Ported so far: batch
serving — config, lookup, MLPs, the dot interaction (plain torch, and
hand-written CUDA forward and backward kernels in ``csrc/``), the model
forward, the Criteo loader and ``python -m dlrm_tpu_torch predict`` — and
single-device exact-SGD training: the loss, compressed embedding gradients,
the train step and loop, learning-rate schedules and
``python -m dlrm_tpu_torch train``.
"""

from dlrm_tpu_torch.config import (
    DLRMConfig,
    KAGGLE_TABLE_SIZES,
    TERABYTE_TABLE_SIZES,
    fixture_config,
    kaggle_config,
    multi_fixture_config,
    terabyte_config,
    tiny_config,
)
from dlrm_tpu_torch.models.dlrm import forward, init_params
from dlrm_tpu_torch.train.train import (init_train_state, make_train_step,
                                        train, train_step)

__all__ = [
    "DLRMConfig", "KAGGLE_TABLE_SIZES", "TERABYTE_TABLE_SIZES",
    "fixture_config", "kaggle_config", "multi_fixture_config",
    "terabyte_config", "tiny_config", "forward", "init_params",
    "init_train_state", "make_train_step", "train", "train_step",
]

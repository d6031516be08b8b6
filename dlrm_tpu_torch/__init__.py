"""dlrm_tpu_torch — the PyTorch/CUDA port of ``dlrm_tpu`` for one NVIDIA
H100.

It mirrors ``dlrm_tpu``'s module layout and names.  Ported so far: batch
serving — config, lookup, MLPs, the dot interaction (plain torch, and
hand-written CUDA forward and backward kernels in ``csrc/``), the model
forward, the Criteo loader and ``python -m dlrm_tpu_torch predict`` — and
single-device training: the loss, compressed embedding gradients, the train
step and loop, SGD, Adagrad and row-wise Adagrad, gradient clipping,
coalesced K-step blocks, learning-rate schedules, evaluation (accuracy, AUC,
loss) and ``python -m dlrm_tpu_torch train`` / ``eval``; the Criteo pipeline
(parsing, vocabulary, a native engine built from ``native/``, batches copied
to the card ahead of the step), HDF5 interop and the fixture validator, and
int8 serving (``preprocess``, ``validate``, ``--hdf5``,
``--quantize-tables int8``); checkpoints and resume in plain files
(``io/checkpoint.py``: ``train --ckpt-dir --save-interval --max-to-keep``,
``eval`` / ``predict`` / ``export --ckpt-dir``), ``export`` to HDF5 or to a
ready-to-serve int8 checkpoint, and telemetry (``utils/telemetry.py``: the
phase scopes of the forward and the training step, ``Recorder``,
``InstrumentedTrainer``, ``trace``; ``instrument``, ``bench``, ``train
--profile-dir``).
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
from dlrm_tpu_torch.ops.loss import bce_loss
from dlrm_tpu_torch.train.train import (init_opt_state, init_train_state,
                                        make_train_step, make_train_step_opt,
                                        train, train_step, train_step_opt)

__all__ = [
    "DLRMConfig", "KAGGLE_TABLE_SIZES", "TERABYTE_TABLE_SIZES",
    "fixture_config", "kaggle_config", "multi_fixture_config",
    "terabyte_config", "tiny_config", "forward", "init_params", "bce_loss",
    "init_train_state", "make_train_step", "train", "train_step",
    "init_opt_state", "make_train_step_opt", "train_step_opt",
]

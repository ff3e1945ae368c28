"""fp16 training: loss scaling.

Counterpart of ``smdistributed_modelparallel_tpu/fp16/``. The step engine
keeps fp32 master parameters and runs the forward on half casts
(``step.py``); what remains explicit is loss scaling.
"""

from smdistributed_modelparallel_tpu_torch.fp16.loss_scaler import (
    DynamicLossScaler,
    LossScaler,
)

__all__ = ["DynamicLossScaler", "LossScaler"]

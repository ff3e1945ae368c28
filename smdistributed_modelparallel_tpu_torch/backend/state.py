"""Process-wide framework state of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/backend/state.py``. This
package runs on one device in one process, so the state is the resolved
config, whether ``smp.init`` ran, the device that ``smp.init`` named (None:
a ``DistributedModel`` resolves it to cuda), the current model and
optimizer, the fp16 loss scaler (a ``DynamicLossScaler`` when the config
asks for fp16, as in the JAX package) and the fp8 delayed-scaling state
(``quant.QuantState``, created by the first step under
``matmul_precision: fp8``).
"""


class ModelParallelState:
    def __init__(self):
        self.reset()

    @property
    def initialized(self):
        return self.cfg is not None

    def initialize(self, cfg, device=None):
        self.reset()
        self.cfg = cfg
        self.device = device
        if cfg.fp16:
            from smdistributed_modelparallel_tpu_torch.fp16.loss_scaler import DynamicLossScaler

            self.loss_scaler = DynamicLossScaler()

    def reset(self):
        self.cfg = None
        self.device = None
        self.model = None
        self.optimizer = None
        self.loss_scaler = None
        self.quant_state = None


state = ModelParallelState()

"""Process-wide framework state of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/backend/state.py``. This
package runs on one device in one process, so the state is the resolved
config, whether ``smp.init`` ran, and the device that ``smp.init`` named
(None: a ``DistributedModel`` resolves it to cuda).
"""


class ModelParallelState:
    def __init__(self):
        self.cfg = None
        self.device = None

    @property
    def initialized(self):
        return self.cfg is not None

    def initialize(self, cfg, device=None):
        self.cfg = cfg
        self.device = device

    def reset(self):
        self.cfg = None
        self.device = None


state = ModelParallelState()

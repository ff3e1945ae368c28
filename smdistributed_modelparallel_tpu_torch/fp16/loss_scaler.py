"""Loss scalers for fp16 training.

Counterpart of ``smdistributed_modelparallel_tpu/fp16/loss_scaler.py``:
``LossScaler`` (static) and ``DynamicLossScaler`` (overflow-driven backoff
and growth), with the same scale arithmetic, defaults and ``state_dict``
keys. On one device the overflow flag is one value, so no agreement across
ranks is needed. Each overflow and growth is a telemetry event
(``record_loss_scale``: the events counter, the scale gauge and a
flight-recorder health entry), as in the JAX package.
"""

from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import record_loss_scale

logger = get_logger()


class LossScaler:
    """Static loss scale."""

    def __init__(self, scale=2.0 ** 16):
        self._scale = float(scale)

    @property
    def loss_scale(self):
        return self._scale

    def update(self, found_overflow):
        if found_overflow:
            record_loss_scale("static_overflow", self._scale)
            logger.warning(
                "Gradient overflow with static loss scale %.1f; step skipped.",
                self._scale,
            )

    def state_dict(self):
        return {"scale": self._scale}

    def load_state_dict(self, sd):
        self._scale = float(sd["scale"])


class DynamicLossScaler(LossScaler):
    """Dynamic loss scale: multiply by ``backoff_factor`` (default
    1/scale_factor) on overflow, by ``scale_factor`` after ``scale_window``
    consecutive clean steps; the reference's defaults (init 2**32, factor 2,
    window 1000, min_scale 1)."""

    def __init__(self, init_scale=2.0 ** 32, scale_factor=2.0,
                 scale_window=1000, min_scale=1.0, delayed_shift=1,
                 consecutive_hysteresis=False, backoff_factor=None):
        super().__init__(init_scale)
        self.scale_factor = float(scale_factor)
        self.backoff_factor = (
            1.0 / self.scale_factor if backoff_factor is None
            else float(backoff_factor)
        )
        self.scale_window = int(scale_window)
        self.min_scale = float(min_scale)
        self.delayed_shift = int(delayed_shift)
        self.consecutive_hysteresis = consecutive_hysteresis
        self.cur_hysteresis = self.delayed_shift
        self._good_steps = 0
        self.overflows = 0

    def update(self, found_overflow):
        if found_overflow:
            self.overflows += 1
            if self.delayed_shift == 1 or self.cur_hysteresis == 1:
                self._scale = max(self._scale * self.backoff_factor, self.min_scale)
                logger.info("Gradient overflow; loss scale -> %.1f", self._scale)
            else:
                self.cur_hysteresis -= 1
            self._good_steps = 0
            record_loss_scale("overflow", self._scale)
        else:
            if self.consecutive_hysteresis:
                self.cur_hysteresis = self.delayed_shift
            self._good_steps += 1
            if self._good_steps % self.scale_window == 0:
                if not self.consecutive_hysteresis:
                    self.cur_hysteresis = self.delayed_shift
                self._scale *= self.scale_factor
                logger.info("Loss scale grown -> %.1f", self._scale)
                record_loss_scale("growth", self._scale)

    def state_dict(self):
        return {
            "scale": self._scale,
            "good_steps": self._good_steps,
            "cur_hysteresis": self.cur_hysteresis,
            "overflows": self.overflows,
        }

    def load_state_dict(self, sd):
        self._scale = float(sd["scale"])
        self._good_steps = int(sd.get("good_steps", 0))
        self.cur_hysteresis = int(sd.get("cur_hysteresis", self.delayed_shift))
        self.overflows = int(sd.get("overflows", 0))

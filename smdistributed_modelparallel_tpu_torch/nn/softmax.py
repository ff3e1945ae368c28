"""The scaled-masked softmax surfaces of ``smp.nn``.

Counterpart of ``smdistributed_modelparallel_tpu/nn/softmax.py``. The JAX
package leaves these to XLA (no Pallas kernel computes them); here they are
the same arithmetic in PyTorch: the scores in fp32, times ``scale``, a bool
mask (True keeps) sent to ``finfo(fp32).min`` or an additive mask added, the
softmax over the last axis, and the result cast back to the scores' dtype.
The attention layers do not call them: their scores never materialize on the
flash path (``ops/attention.py``).
"""

import torch

from smdistributed_modelparallel_tpu_torch.ops.attention import causal_window_mask


def scaled_masked_softmax(scores, mask, scale=1.0):
    """softmax(scores * scale + mask_bias) over the last axis.

    ``mask``: bool (True = keep) or an additive bias, broadcastable to
    ``scores``; None for no masking.
    """
    s = scores.float() * scale
    if mask is not None:
        if mask.dtype == torch.bool:
            s = torch.where(mask, s, torch.finfo(s.dtype).min)
        else:
            s = s + mask
    return torch.softmax(s, dim=-1).to(scores.dtype)


def scaled_causal_masked_softmax(scores, scale=1.0, window=None):
    """The causal form, banded to ``window`` keys when given; scores
    [..., T, S]."""
    T, S = scores.shape[-2], scores.shape[-1]
    return scaled_masked_softmax(scores, causal_window_mask(T, S, window, device=scores.device), scale)

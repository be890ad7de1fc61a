"""Dense semantic decoder (counterpart of nicr_mtsa_tpu/models/
decoders/semantic.py SemanticDecoder)."""
from math import log2

from .base import DenseDecoderBase
from .heads import TaskHead


class SemanticDecoder(DenseDecoderBase):
    def __init__(self, n_classes: int = 40,
                 defer_prediction_upsampling=False, generator=None,
                 **kwargs):
        super().__init__(generator=generator, **kwargs)
        self.task_head = TaskHead(
            self.n_channels_last, n_classes,
            upsampling=self.prediction_upsampling,
            n_upsamplings=int(log2(self.downsamplings[-1])),
            defer_last_upsampling=defer_prediction_upsampling,
            generator=generator)

    def apply_task_head(self, x):
        return self.task_head(x)

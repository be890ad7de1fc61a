"""Semantic decoders, dense and MLP (counterpart of nicr_mtsa_tpu/
models/decoders/semantic.py). With `side_heads`, the dense decoder has
a 1x1 `TaskHead` a side output (`side_head{i}`)."""
from math import log2

from .base import DenseDecoderBase, MLPDecoderBase
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
        if self.side_heads:
            for i, n in enumerate(self.side_output_n_channels):
                self.add_module(f'side_head{i}', TaskHead(
                    n, n_classes, n_upsamplings=0, generator=generator))

    def apply_task_head(self, x):
        return self.task_head(x)


class SemanticMLPDecoder(MLPDecoderBase):
    def __init__(self, n_classes: int = 40, n_upsamplings=None,
                 defer_prediction_upsampling=False, generator=None,
                 **kwargs):
        super().__init__(generator=generator, **kwargs)
        n_up = (self.downsampling_in_heads // 2 if n_upsamplings is None
                else n_upsamplings)
        self.task_head = TaskHead(
            self.head_n_channels, n_classes,
            upsampling=self.prediction_upsampling, n_upsamplings=n_up,
            defer_last_upsampling=defer_prediction_upsampling,
            generator=generator)

    def apply_task_head(self, x):
        return self.task_head(x)

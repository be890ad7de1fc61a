"""Surface-normal decoders, dense and MLP (counterpart of
nicr_mtsa_tpu/models/decoders/normal.py): a 3-channel `TaskHead` whose
output is normalised to unit length per pixel (`post='unit-length'`).
With `side_heads`, the dense decoder has a 1x1 unit-length `TaskHead`
a side output (`side_head{i}`)."""
from math import log2

from .base import DenseDecoderBase, MLPDecoderBase
from .heads import TaskHead


class NormalDecoder(DenseDecoderBase):
    def __init__(self, generator=None, **kwargs):
        super().__init__(generator=generator, **kwargs)
        self.task_head = TaskHead(
            self.n_channels_last, 3, upsampling=self.prediction_upsampling,
            n_upsamplings=int(log2(self.downsamplings[-1])),
            post='unit-length', generator=generator)
        if self.side_heads:
            for i, n in enumerate(self.side_output_n_channels):
                self.add_module(f'side_head{i}', TaskHead(
                    n, 3, n_upsamplings=0, post='unit-length',
                    generator=generator))

    def apply_task_head(self, x):
        return self.task_head(x)


class NormalMLPDecoder(MLPDecoderBase):
    def __init__(self, generator=None, **kwargs):
        super().__init__(generator=generator, **kwargs)
        self.task_head = TaskHead(
            self.head_n_channels, 3, upsampling=self.prediction_upsampling,
            n_upsamplings=self.downsampling_in_heads // 2,
            post='unit-length', generator=generator)

    def apply_task_head(self, x):
        return self.task_head(x)

"""Instance decoders, dense and MLP, with the centre/offset
(/orientation) head (counterpart of nicr_mtsa_tpu/models/decoders/
instance.py). With `side_heads`, the dense decoder has an
`InstanceHead` with 1x1 output convs a side output (`side_head{i}`)."""
from math import log2

from .base import DenseDecoderBase, MLPDecoderBase
from .heads import InstanceHead


class InstanceDecoder(DenseDecoderBase):
    def __init__(self, n_channels_per_task: int = 32,
                 with_orientation: bool = False, generator=None, **kwargs):
        super().__init__(generator=generator, **kwargs)
        self.task_head = InstanceHead(
            self.n_channels_last, n_channels_per_task=n_channels_per_task,
            with_orientation=with_orientation, norm=self.norm,
            act=self.act, upsampling=self.prediction_upsampling,
            n_upsamplings=int(log2(self.downsamplings[-1])),
            generator=generator)
        if self.side_heads:
            for i, n in enumerate(self.side_output_n_channels):
                self.add_module(f'side_head{i}', InstanceHead(
                    n, n_channels_per_task=n_channels_per_task,
                    with_orientation=with_orientation, norm=self.norm,
                    act=self.act, n_upsamplings=0, generator=generator))

    def apply_task_head(self, x):
        return self.task_head(x)


class InstanceMLPDecoder(MLPDecoderBase):
    def __init__(self, n_channels_per_task: int = 32,
                 with_orientation: bool = False, generator=None, **kwargs):
        super().__init__(generator=generator, **kwargs)
        self.task_head = InstanceHead(
            self.head_n_channels, n_channels_per_task=n_channels_per_task,
            with_orientation=with_orientation, norm=self.norm,
            act=self.act, upsampling=self.prediction_upsampling,
            n_upsamplings=self.downsampling_in_heads // 2,
            generator=generator)

    def apply_task_head(self, x):
        return self.task_head(x)

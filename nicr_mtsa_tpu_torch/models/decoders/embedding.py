"""Dense-visual-embedding decoders: an `embedding_dim`-channel map at
full resolution (counterpart of nicr_mtsa_tpu/models/decoders/
embedding.py): `EmbeddingDecoder` on the dense ladder (with
`side_heads`, a 1x1 `TaskHead` a side output, `side_head{i}`) and
`EmbeddingMLPDecoder` on the MLP decoder."""
from math import log2

from .base import DenseDecoderBase, MLPDecoderBase
from .heads import TaskHead


class EmbeddingDecoder(DenseDecoderBase):
    def __init__(self, embedding_dim: int = 512, generator=None, **kwargs):
        super().__init__(generator=generator, **kwargs)
        self.task_head = TaskHead(
            self.n_channels_last, embedding_dim,
            upsampling=self.prediction_upsampling,
            n_upsamplings=int(log2(self.downsamplings[-1])),
            generator=generator)
        if self.side_heads:
            for i, n in enumerate(self.side_output_n_channels):
                self.add_module(f'side_head{i}', TaskHead(
                    n, embedding_dim, n_upsamplings=0, generator=generator))

    def apply_task_head(self, x):
        return self.task_head(x)


class EmbeddingMLPDecoder(MLPDecoderBase):
    def __init__(self, embedding_dim: int = 512, generator=None, **kwargs):
        super().__init__(generator=generator, **kwargs)
        self.task_head = TaskHead(
            self.head_n_channels, embedding_dim,
            upsampling=self.prediction_upsampling,
            n_upsamplings=self.downsampling_in_heads // 2,
            generator=generator)

    def apply_task_head(self, x):
        return self.task_head(x)

"""Dense-visual-embedding MLP decoder: an `embedding_dim`-channel map at
full resolution (counterpart of nicr_mtsa_tpu/models/decoders/
embedding.py `EmbeddingMLPDecoder`)."""
from .base import MLPDecoderBase
from .heads import TaskHead


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

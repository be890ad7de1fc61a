from .base import (DenseDecoderBase, DenseDecoderModule, MLPDecoderBase,
                   plan_dense_ladder)
from .embedding import EmbeddingMLPDecoder
from .heads import InstanceHead, TaskHead
from .instance import InstanceDecoder, InstanceMLPDecoder
from .scene import SceneClassificationDecoder
from .semantic import SemanticDecoder, SemanticMLPDecoder

__all__ = ['DenseDecoderBase', 'DenseDecoderModule', 'MLPDecoderBase',
           'plan_dense_ladder', 'EmbeddingMLPDecoder', 'InstanceHead',
           'TaskHead', 'InstanceDecoder', 'InstanceMLPDecoder',
           'SceneClassificationDecoder', 'SemanticDecoder',
           'SemanticMLPDecoder']

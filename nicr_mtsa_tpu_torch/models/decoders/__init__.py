from .base import (DenseDecoderBase, DenseDecoderModule, MLPDecoderBase,
                   plan_dense_ladder)
from .embedding import EmbeddingDecoder, EmbeddingMLPDecoder
from .heads import InstanceHead, TaskHead
from .instance import InstanceDecoder, InstanceMLPDecoder
from .normal import NormalDecoder, NormalMLPDecoder
from .panoptic import PanopticHelper
from .scene import SceneClassificationDecoder
from .semantic import SemanticDecoder, SemanticMLPDecoder

__all__ = ['DenseDecoderBase', 'DenseDecoderModule', 'MLPDecoderBase',
           'plan_dense_ladder', 'EmbeddingDecoder', 'EmbeddingMLPDecoder',
           'InstanceHead', 'TaskHead', 'InstanceDecoder',
           'InstanceMLPDecoder', 'NormalDecoder', 'NormalMLPDecoder',
           'PanopticHelper', 'SceneClassificationDecoder',
           'SemanticDecoder', 'SemanticMLPDecoder']

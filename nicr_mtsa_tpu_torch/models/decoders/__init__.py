from .base import DenseDecoderBase, DenseDecoderModule, plan_dense_ladder
from .heads import InstanceHead, TaskHead
from .instance import InstanceDecoder
from .scene import SceneClassificationDecoder
from .semantic import SemanticDecoder

__all__ = ['DenseDecoderBase', 'DenseDecoderModule', 'plan_dense_ladder',
           'InstanceHead', 'TaskHead', 'InstanceDecoder',
           'SceneClassificationDecoder', 'SemanticDecoder']

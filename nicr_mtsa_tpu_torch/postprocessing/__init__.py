from .base import PostprocessingBase
from .dense_visual_embedding import DenseVisualEmbeddingPostprocessing
from .instance import InstancePostprocessing
from .normal import NormalPostprocessing
from .panoptic import PanopticPostprocessing
from .scene import ScenePostprocessing
from .semantic import SemanticPostprocessing

__all__ = ['PostprocessingBase', 'DenseVisualEmbeddingPostprocessing',
           'InstancePostprocessing', 'NormalPostprocessing',
           'PanopticPostprocessing', 'ScenePostprocessing',
           'SemanticPostprocessing']

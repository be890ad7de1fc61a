from .base import PostprocessingBase
from .instance import InstancePostprocessing
from .panoptic import PanopticPostprocessing
from .scene import ScenePostprocessing
from .semantic import SemanticPostprocessing

__all__ = ['PostprocessingBase', 'InstancePostprocessing',
           'PanopticPostprocessing', 'ScenePostprocessing',
           'SemanticPostprocessing']

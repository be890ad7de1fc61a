from .multi_task import MultiTaskModel, MultiTaskModelConfig, build_model
from .upsampling import (DeferredBilinear2, DeferredUpsampling,
                         DeferredUpsampling2)

__all__ = ['MultiTaskModel', 'MultiTaskModelConfig', 'build_model',
           'DeferredBilinear2', 'DeferredUpsampling', 'DeferredUpsampling2']

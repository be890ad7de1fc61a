from .multi_task import MultiTaskModel, MultiTaskModelConfig, build_model
from .upsampling import DeferredUpsampling2

__all__ = ['MultiTaskModel', 'MultiTaskModelConfig', 'build_model',
           'DeferredUpsampling2']

"""Multi-task loss weighting (counterpart of nicr_mtsa_tpu/weighting/):
fixed weights, Dynamic Weight Average and Random Loss Weighting, as
host-side state machines over the per-task total losses."""
from .base import LossWeightingBase
from .dwa import DynamicWeightAverage
from .fixed import FixedLossWeighting
from .rlw import RandomLossWeighting

__all__ = ['LossWeightingBase', 'DynamicWeightAverage', 'FixedLossWeighting',
           'RandomLossWeighting']

"""PyTorch/CUDA port of nicr_mtsa_tpu, slice 1: EMSANet panoptic serving.

The JAX package `nicr_mtsa_tpu` stays the reference; this package is
held against it on the same weights and inputs (tests/test_torch_*.py).
It imports torch and numpy only. Models compute in NCHW; the public
entry points keep the JAX package's layouts at their boundary
((B, H, W, 3) uint8 RGB, (B, H, W) uint16 depth, (B, H, W) maps).

Entry points run on `cuda` unless the caller passes `device='cpu'`;
on the card the two serving kernels (ops/cuda/) are hand-written CUDA
C++ for sm_90a, built at first use."""
from .models.multi_task import MultiTaskModelConfig, build_model
from .pipeline import PanopticInferencePipeline, build_serving_pipeline

__all__ = ['MultiTaskModelConfig', 'build_model',
           'PanopticInferencePipeline', 'build_serving_pipeline']

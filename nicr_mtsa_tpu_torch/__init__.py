"""PyTorch/CUDA port of nicr_mtsa_tpu: EMSANet panoptic serving (slice
1), the metric-inclusive fused eval step (slice 2), EMSAFormer
(SwinV2-T-128 RGB-D) serving (slice 3), its training step (slice 4),
and the two opt-in serving variants, EMSANet with the single 2x
finisher and EMSAFormer with attention over the packed qkv (slice 5),
EMSANet training (slice 13), the EMSAFormer/DVE eval step (slice 14)
and the host data path (slice 15: `data/`, `native.py`): the
directory dataset, the eval preprocessing on the native host library,
the loader and the pinned prefetcher that feeds the card.

The JAX package `nicr_mtsa_tpu` stays the reference; this package is
held against it on the same weights and inputs (tests/test_torch_*.py).
It imports torch and numpy only. Models compute in NCHW; the public
entry points keep the JAX package's layouts at their boundary
((B, H, W, 3) uint8 RGB, (B, H, W) uint16 depth, (B, H, W) maps).

Entry points run on `cuda` unless the caller passes `device='cpu'`;
on the card the kernels of both paths (ops/cuda/) are hand-written
CUDA C++ for sm_90a, built at first use."""
from .models.multi_task import MultiTaskModelConfig, build_model
from .pipeline import (MultiTaskPipeline, PanopticInferencePipeline,
                       build_eval_pipeline, build_serving_pipeline,
                       build_train_pipeline)

__all__ = ['MultiTaskModelConfig', 'build_model', 'MultiTaskPipeline',
           'PanopticInferencePipeline', 'build_eval_pipeline',
           'build_serving_pipeline', 'build_train_pipeline']

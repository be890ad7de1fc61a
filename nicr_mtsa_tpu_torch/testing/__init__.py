"""Synthetic inputs for driving the port (eval batches)."""
from .batch import (EvalBatch, GroundTruth, build_eval_batch, eval_arrays,
                    synthetic_ground_truth)

__all__ = ['EvalBatch', 'GroundTruth', 'build_eval_batch', 'eval_arrays',
           'synthetic_ground_truth']

"""Synthetic inputs for driving the port (training and eval batches)."""
from .batch import (EvalBatch, GroundTruth, build_eval_batch,
                    build_train_batch, dve_arrays, dve_tables, eval_arrays,
                    synthetic_ground_truth, train_arrays)

__all__ = ['EvalBatch', 'GroundTruth', 'build_eval_batch',
           'build_train_batch', 'dve_arrays', 'dve_tables', 'eval_arrays',
           'synthetic_ground_truth', 'train_arrays']

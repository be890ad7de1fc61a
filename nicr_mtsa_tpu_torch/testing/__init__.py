"""Synthetic inputs for driving the port: training and eval batches,
the tests' dummy sample and the synthetic RGB-D dataset."""
from .batch import (EvalBatch, GroundTruth, build_eval_batch,
                    build_train_batch, dve_arrays, dve_tables, eval_arrays,
                    synthetic_ground_truth, train_arrays)
from .dataset import SyntheticRGBDDataset, get_dataloader, get_dataset
from .preprocessing import get_dummy_sample

__all__ = ['EvalBatch', 'GroundTruth', 'build_eval_batch',
           'build_train_batch', 'dve_arrays', 'dve_tables', 'eval_arrays',
           'synthetic_ground_truth', 'train_arrays', 'SyntheticRGBDDataset',
           'get_dataloader', 'get_dataset', 'get_dummy_sample']

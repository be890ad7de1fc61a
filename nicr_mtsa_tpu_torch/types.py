"""Core type aliases of the batch-dict pipeline (counterpart of
nicr_mtsa_tpu/types.py, over `torch.Tensor` in place of `jax.Array`).

The library's real API is a dict of string keys flowing through
preprocessing -> collate -> model -> postprocessing -> task helpers.
Samples hold per-image numpy arrays on the host; batches hold stacked
tensors on the host or the card."""
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

ArrayType = Union[np.ndarray, torch.Tensor]

# a single sample (host, numpy) or a collated batch (host or device)
SampleType = Dict[str, Any]
BatchType = Dict[str, Any]

# encoder contract: {modality: array} for inputs/outputs; skips are
# {str(downsampling): {modality: array}}
EncoderInputType = Dict[str, ArrayType]
EncoderSkipsType = Dict[str, Dict[str, ArrayType]]
EncoderOutputType = Tuple[EncoderInputType, EncoderSkipsType]

# context module returns (features, tuple of per-bin context branches)
ContextModuleOutputType = Tuple[ArrayType, Tuple[ArrayType, ...]]

# decoders consume (context_features, context_branches) and produce
# (main_output, side_outputs); outputs may be tuples for multi-head tasks
DecoderInputType = Tuple[ArrayType, Tuple[ArrayType, ...]]
DecoderRawOutputType = Tuple[Any, Tuple[Any, ...]]

# postprocessing emits a flat dict of result keys
PostprocessingOutputType = Dict[str, Any]

# loss protocol: per-scale tuples of (loss_sum, n_elements)
LossOutputType = Tuple[Tuple[ArrayType, ArrayType], ...]

__all__ = [
    'ArrayType', 'SampleType', 'BatchType',
    'EncoderInputType', 'EncoderSkipsType', 'EncoderOutputType',
    'ContextModuleOutputType', 'DecoderInputType', 'DecoderRawOutputType',
    'PostprocessingOutputType', 'LossOutputType',
]

"""The host data path (counterpart of nicr_mtsa_tpu/data/): the
directory dataset and its PNG codec, the preprocessing steps, collate,
the threaded loader and the hand-off to the card (`move_batch_to_device`,
the pinned prefetcher `prefetch_to_device`); `fullres` holds the
full-resolution keys and provenance readers, `targets` the numpy target
generators."""
from ._collate import RandomSamplerSubset, collate, mt_collate
from ._types import (AppliedPreprocessingMeta, CollateIgnoredDict,
                     OrientationDict, PreprocessingParameterDict)
from ._utils import infer_batch_size, move_batch_to_device
from .dataset import (DatasetConfig, DirectoryRGBDDataset, SemanticLabel,
                      SemanticLabelList, get_dataset,
                      write_directory_dataset)
from .feeder import prefetch_to_device
from .loader import DataLoader
from . import preprocessing

__all__ = ['RandomSamplerSubset', 'collate', 'mt_collate',
           'AppliedPreprocessingMeta', 'CollateIgnoredDict', 'OrientationDict',
           'PreprocessingParameterDict', 'infer_batch_size',
           'move_batch_to_device', 'DatasetConfig', 'DirectoryRGBDDataset',
           'SemanticLabel', 'SemanticLabelList', 'get_dataset',
           'write_directory_dataset', 'prefetch_to_device', 'DataLoader',
           'preprocessing']

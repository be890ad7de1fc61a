"""Host-side preprocessing of samples (counterpart of
nicr_mtsa_tpu/data/preprocessing/, the steps of the eval and the
training path, augmentations included): numpy in, numpy out, one
sample at a time."""
from .augmentation import (RandomCrop, RandomHorizontalFlip,
                           RandomHSVJitter)
from .base import (APPLIED_PREPROCESSING_KEY, MULTI_DOWNSCALE_KEY_FMT,
                   Compose, PreprocessingBase,
                   add_to_applied_preprocessing_meta,
                   get_applied_preprocessing_meta)
from .clone import (DEFAULT_CLONE_KEY, CloneEntries, FlatCloneEntries,
                    clone_entries)
from .dense_visual_embedding import DenseVisualEmbeddingTargetGenerator
from .device import ToDeviceArrays
from .instance import InstanceClearStuffIDs, InstanceTargetGenerator
from .multiscale_supervision import (MultiscaleSupervisionGenerator,
                                     get_downscale)
from .normalize import (RGB_MEAN, RGB_STD, NormalizeDepth, NormalizeRGB,
                        ScaleDepth, normalize)
from .orientation import OrientationTargetGenerator
from .panoptic import PanopticTargetGenerator, segment_table_overflow
from .resize import FullResCloner, RandomResize, Resize, pad, resize
from .semantic import SemanticClassMapper
from .transform_wrapper import TransformWrapper, five_crop, ten_crop
from .utils import KeyCleaner
from ..fullres import (FULLRES_SUFFIX, get_fullres, get_fullres_key,
                       get_fullres_shape, get_valid_region_slices,
                       get_valid_region_slices_and_fullres_shape)

__all__ = [
    'RandomCrop', 'RandomHorizontalFlip', 'RandomHSVJitter', 'RandomResize',
    'APPLIED_PREPROCESSING_KEY', 'MULTI_DOWNSCALE_KEY_FMT', 'Compose',
    'PreprocessingBase', 'add_to_applied_preprocessing_meta',
    'get_applied_preprocessing_meta', 'DEFAULT_CLONE_KEY', 'CloneEntries',
    'FlatCloneEntries', 'clone_entries',
    'DenseVisualEmbeddingTargetGenerator', 'ToDeviceArrays',
    'InstanceClearStuffIDs', 'InstanceTargetGenerator',
    'MultiscaleSupervisionGenerator', 'get_downscale', 'RGB_MEAN', 'RGB_STD',
    'NormalizeDepth', 'NormalizeRGB', 'ScaleDepth', 'normalize',
    'OrientationTargetGenerator', 'PanopticTargetGenerator',
    'segment_table_overflow', 'FullResCloner', 'Resize', 'pad', 'resize',
    'SemanticClassMapper', 'TransformWrapper', 'five_crop', 'ten_crop',
    'KeyCleaner', 'FULLRES_SUFFIX', 'get_fullres', 'get_fullres_key',
    'get_fullres_shape', 'get_valid_region_slices',
    'get_valid_region_slices_and_fullres_shape']

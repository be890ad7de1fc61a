"""Panoptic targets by the naive merge of semantic and instance ground
truth (own copy of nicr_mtsa_tpu/data/preprocessing/panoptic.py), on
data/targets.py: the panoptic map and its {panoptic id: instance id}
dict at the working resolution (and in every `_down_<k>` sub-sample)
and at full resolution, each with a sorted segment table of
`segment_table_size` slots padded with SEGMENT_TABLE_PAD (the device
PQ metric maps ids to slots through it), and at full resolution the GT
angle of each slot.

The JAX generator records how many ids the working-resolution table
could not hold (`segment_table_overflow`) and truncates the
full-resolution one without a word; this one also records the latter,
as `segment_table_overflow_fullres` in the same provenance entry, so
that the sample's arrays stay exactly the JAX package's.
`segment_table_overflow(sample_or_batch)` sums every count."""
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from .._types import CollateIgnoredDict
from ..fullres import APPLIED_PREPROCESSING_KEY
from ..targets import (MAX_INSTANCES_PER_CATEGORY, angle_tables,
                       merge_targets, segment_table)
from .base import PreprocessingBase
from .utils import _keys_available

DEFAULT_SEGMENT_TABLE_SIZE = 256
OVERFLOW_KEYS = ('segment_table_overflow', 'segment_table_overflow_fullres')


class PanopticTargetGenerator(PreprocessingBase):
    def __init__(self,
                 semantic_classes_is_thing: Optional[Sequence[bool]] = None,
                 multiscale_processing: bool = True,
                 segment_table_size: int = DEFAULT_SEGMENT_TABLE_SIZE) -> None:
        self._thing_class_ids = None if semantic_classes_is_thing is None \
            else np.flatnonzero(np.asarray(semantic_classes_is_thing))
        self._segment_table_size = segment_table_size
        super().__init__(
            multiscale_processing=multiscale_processing,
            fixed_parameters=dict(
                max_instances_per_category=MAX_INSTANCES_PER_CATEGORY,
                void_label=0))

    def _preprocess(self, sample: dict, **kwargs
                    ) -> Tuple[dict, Dict[str, Any]]:
        if not _keys_available(sample, ('instance', 'semantic')):
            return sample, {}
        thing_ids = self._thing_class_ids
        size = self._segment_table_size

        pan, id_dict = merge_targets(sample['semantic'], sample['instance'],
                                     thing_ids)
        sample['panoptic'] = pan
        sample['panoptic_ids_to_instance_dict'] = CollateIgnoredDict(id_dict)
        sample['panoptic_segment_table'], overflow = segment_table(pan, size)
        dynamic = {'thing_semantic_classes': thing_ids,
                   'segment_table_overflow': overflow}

        # the full-resolution targets, against which the task helpers
        # score PQ
        sem_full = sample.get('semantic_fullres')
        ins_full = sample.get('instance_fullres')
        if sem_full is not None and ins_full is not None \
                and 'panoptic_fullres' not in sample:
            pan_f, id_dict_f = merge_targets(sem_full, ins_full, thing_ids)
            sample['panoptic_fullres'] = pan_f
            sample['panoptic_ids_to_instance_dict_fullres'] = \
                CollateIgnoredDict(id_dict_f)
            table_f, overflow_f = segment_table(pan_f, size)
            sample['panoptic_segment_table_fullres'] = table_f
            dynamic['segment_table_overflow_fullres'] = overflow_f
            if 'orientations' in sample:
                (sample['panoptic_gt_angle_table'],
                 sample['panoptic_gt_angle_table_valid']) = angle_tables(
                     table_f, id_dict_f, sample['orientations'])
        return sample, dynamic


def segment_table_overflow(sample: dict) -> int:
    """The GT ids that the segment tables of a sample (or of a collated
    batch, or of a list of samples' provenance) could not hold: the sum
    of the generator's counts over every record, sub-sample included."""
    def total(record) -> int:
        if isinstance(record, list):
            return sum(total(r) for r in record)
        if not isinstance(record, dict):
            return 0
        return sum(int(v) if k in OVERFLOW_KEYS else total(v)
                   for k, v in record.items())
    return total(sample.get(APPLIED_PREPROCESSING_KEY, []))

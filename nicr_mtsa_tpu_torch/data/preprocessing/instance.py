"""Panoptic-DeepLab instance targets (own copy of
nicr_mtsa_tpu/data/preprocessing/instance.py), on
data/targets.instance_targets:

- `InstanceClearStuffIDs`: instance id 0 on every stuff and void pixel,
  so that each stuff class is one segment;
- `InstanceTargetGenerator`: the Gaussian centre heatmap, the offsets
  to the centre (normalised by H and W by default), the foreground and
  the centre-loss mask, at the working resolution and, with
  `sigma_for_additional_downscales`, in every `_down_<k>` sub-sample
  with its own sigma."""
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..fullres import get_fullres
from ..targets import instance_targets
from .base import PreprocessingBase
from .utils import _keys_available


class InstanceClearStuffIDs(PreprocessingBase):
    """Zero the instance id on every stuff and void pixel (a stray
    instance on a stuff class would become a phantom thing segment)."""

    def __init__(self,
                 semantic_classes_is_thing: Optional[Sequence[bool]] = None,
                 multiscale_processing: bool = True,
                 disable_stats: bool = False) -> None:
        self._stuff_class_ids = None if semantic_classes_is_thing is None \
            else np.flatnonzero(~np.asarray(semantic_classes_is_thing))
        self._with_stats = not disable_stats
        super().__init__(
            # the JAX package's provenance: the thing classes come from
            # the argument, never from the sample's meta
            fixed_parameters=dict(use_is_thing_from_meta=False,
                                  disable_stats=disable_stats),
            multiscale_processing=multiscale_processing)

    def _preprocess(self, sample: dict, **kwargs
                    ) -> Tuple[dict, Dict[str, Any]]:
        if not _keys_available(sample, ('instance', 'semantic')):
            return sample, {}
        stuff_ids = self._stuff_class_ids
        on_stuff = np.isin(sample['semantic'], stuff_ids)
        dynamic: Dict[str, Any] = {'stuff_semantic_classes': stuff_ids}
        if self._with_stats:
            cleared_ids, n_pixels = np.unique(
                sample['instance'][on_stuff], return_counts=True)
            dynamic['cleared_instance_pixels'] = dict(zip(cleared_ids,
                                                          n_pixels))
        sample['instance'][on_stuff] = 0
        return sample, dynamic


class InstanceTargetGenerator(PreprocessingBase):
    def __init__(self, sigma: int,
                 semantic_classes_is_thing: Optional[Sequence[bool]] = None,
                 sigma_for_additional_downscales: Optional[
                     Dict[int, int]] = None,
                 normalized_offset: bool = True,
                 multiscale_processing: bool = False) -> None:
        # sigma by downscale; None is the main (working) scale
        self._sigma_by_scale = {None: sigma}
        self._sigma_by_scale.update(sigma_for_additional_downscales or {})
        self._is_thing = None if semantic_classes_is_thing is None \
            else np.asarray(semantic_classes_is_thing, dtype=bool)
        self._normalized_offset = normalized_offset
        super().__init__(
            multiscale_processing=sigma_for_additional_downscales is not None,
            fixed_parameters=dict(
                sigma_for_downscales=self._sigma_by_scale,
                normalized_offset=normalized_offset,
                use_is_thing_from_meta=False))    # as InstanceClearStuffIDs

    def _preprocess(self, sample: dict, downscale=None, **kwargs
                    ) -> Tuple[dict, Dict[str, Any]]:
        if 'instance' not in sample:
            return sample, {}
        is_thing = self._is_thing
        thing_ids = stuff_ids = None
        if is_thing is not None:
            thing_ids = np.flatnonzero(is_thing)
            stuff_ids = np.flatnonzero(~is_thing)[1:]         # without void
        instance = sample['instance']
        semantic = sample.get('semantic')
        # without the semantic map every instance counts as a thing
        targets = instance_targets(
            instance, semantic, is_thing if semantic is not None else None,
            sigma=self._sigma_by_scale[downscale],
            normalized_offset=self._normalized_offset)
        foreground = targets.arrays['instance_foreground']
        if instance[~foreground].any():
            raise ValueError('instance ids on stuff or void pixels: run '
                             'InstanceClearStuffIDs first')
        instance_fullres = get_fullres(sample, 'instance')
        semantic_fullres = get_fullres(sample, 'semantic')
        if instance_fullres is not None and semantic is not None \
                and semantic_fullres is not None \
                and instance_fullres[~np.isin(semantic_fullres,
                                              thing_ids)].any():
            raise ValueError('full-resolution instance ids on stuff or void '
                             'pixels: run InstanceClearStuffIDs first')
        sample.update(targets.arrays)
        return sample, dict(
            encoded_instances=targets.encoded,
            skipped_instances_due_to_stuff=targets.skipped,
            thing_semantic_classes=thing_ids,
            stuff_semantic_classes=stuff_ids)

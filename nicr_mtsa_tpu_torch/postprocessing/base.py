"""Postprocessing base: train/inference dispatch, valid-region crop and
full-resolution resize (counterpart of
nicr_mtsa_tpu/postprocessing/base.py). Dense predictions are NCHW,
maps (B, H, W).

`postprocess` takes an optional `keys`: the output keys a caller reads.
Optional outputs not in it (the full-resolution maps, the PQ slot map)
are not computed (the JAX package leaves their dead-code elimination
to XLA); None computes them all. In training (`is_training=True`)
every postprocessor passes its outputs on (the panoptic one those of
its semantic and instance postprocessors)."""
from typing import Optional, Tuple

from ..data.fullres import (get_fullres_key,
                            get_valid_region_slices_and_fullres_shape,
                            has_valid_region)
from ..models.upsampling import resize_nearest


def crop_and_resize_to_fullres(prediction, valid_region_slices: Tuple[
        slice, slice], shape: Tuple[int, int]):
    """Crop the valid region of a (B, H, W) map and nearest-resize it
    to `shape` (exact for integer maps; the float bilinear mode of the
    JAX package has no caller here)."""
    slice_h, slice_w = valid_region_slices
    prediction = prediction[..., slice_h, slice_w]
    h, w = shape
    if (h, w) == tuple(prediction.shape[-2:]):
        return prediction
    return resize_nearest(prediction, h, w)


def wants(keys, key: str) -> bool:
    return keys is None or key in keys


class PostprocessingBase:
    def postprocess(self, data, batch=None, is_training: bool = False,
                    keys: Optional[frozenset] = None):
        if is_training:
            return self._postprocess_training(data, batch or {})
        return self._postprocess_inference(data, batch or {}, keys)

    def _postprocess_training(self, data, batch):
        raise NotImplementedError(
            f'{type(self).__name__}: training postprocessing is not ported')

    def _postprocess_inference(self, data, batch, keys=None):
        raise NotImplementedError


class DensePostprocessingBase(PostprocessingBase):
    @staticmethod
    def _fullres_args(batch, key):
        return get_valid_region_slices_and_fullres_shape(batch, key)

    def _add_fullres(self, r_dict, batch, source_key: str, keys,
                     shape_key: str) -> None:
        """r_dict[<source_key>_fullres] at the full resolution of the
        batch's `shape_key`, if the batch has a valid region and the
        caller reads that key."""
        key = get_fullres_key(source_key)
        if not (has_valid_region(batch) and wants(keys, key)):
            return
        crop_slices, shape = self._fullres_args(batch, shape_key)
        r_dict[key] = crop_and_resize_to_fullres(r_dict[source_key],
                                                 crop_slices, shape)

"""Semantic postprocessing (counterpart of
nicr_mtsa_tpu/postprocessing/semantic.py). Training passes the outputs
on (a deferred head raises: training applies its upsamplings).
Inference: first-argmax idx and max-softmax score from the fused 2x
finisher for a head that deferred its last upsampling, from the fused
4x finisher for a head that deferred both (learned-3x3-zeropad or
bilinear), else from the logits by the score/argmax kernel; with a
valid region in the batch, the full-resolution idx/score come from the
crop + resize + reduce kernel without building the full-resolution
logits.

The dense keys (the softmax `semantic_softmax_scores`, NCHW in the
logits' dtype, the full-resolution logits `semantic_output_fullres` and
their softmax) are computed only where `keys` names them (`keys=None`
computes every map but no dense key) or the caller passes them in
`extra` (the panoptic scores need the softmax). A deferred head's dense
logits are built only where needed (`semantic_output` named, a dense
key, or full-resolution maps that need a crop or a resize), by
`apply_deferred_upsampling_exact`: the finisher's own rounding, so
`argmax(semantic_softmax_scores) == semantic_segmentation_idx` holds
within one output dict, bf16 ties included; otherwise
`semantic_output` stays the deferred marker."""
import torch

from ..data.fullres import (get_fullres_key,
                            get_valid_region_slices_and_fullres_shape,
                            has_valid_region)
from ..models.upsampling import (DEFERRED_TYPES, DeferredBilinear2,
                                DeferredUpsampling, DeferredUpsampling2,
                                apply_deferred_upsampling_exact,
                                resize_bilinear)
from ..ops.cuda.finisher2x import finish_deferred_semantic
from ..ops.cuda.finisher4x import (finish_deferred_bilinear2,
                                   finish_deferred_semantic2)
from ..ops.cuda.resize_reduce import crop_resize_argmax_score
from ..ops.cuda.semantic_reduce import semantic_argmax_score
from .base import DensePostprocessingBase, wants

SOFTMAX_KEY = 'semantic_softmax_scores'
_FULLRES_KEYS = (get_fullres_key('semantic_segmentation_idx'),
                 get_fullres_key('semantic_segmentation_score'))
_DENSE_FULLRES_KEYS = (get_fullres_key('semantic_output'),
                       get_fullres_key(SOFTMAX_KEY))
_FINISH = {DeferredUpsampling: finish_deferred_semantic,
           DeferredUpsampling2: finish_deferred_semantic2,
           DeferredBilinear2: finish_deferred_bilinear2}
_SCALE = {DeferredUpsampling: 2, DeferredUpsampling2: 4,
          DeferredBilinear2: 4}


def _is_identity(crop_slices, shape, H: int, W: int) -> bool:
    """Whether the valid region is the whole (H, W) image at full size."""
    sy, sx = crop_slices
    return (sy.indices(H) == (0, H, 1) and sx.indices(W) == (0, W, 1)
            and tuple(shape) == (H, W))


def fullres_idx_score(output, batch, idx=None, score=None):
    """(idx, score) at the full resolution of the batch's semantic
    ground truth, of NCHW logits at the working resolution: the
    working-resolution (idx, score) where given and the valid region is
    the whole image at the full size, the score/argmax kernel on the
    crop where only a crop is needed, else the crop + resize + reduce
    kernel (the counterpart of the JAX package's `_fullres_score_idx`;
    its argmax bit-identical to reducing the resized logits)."""
    (sy, sx), (h, w) = get_valid_region_slices_and_fullres_shape(
        batch, 'semantic')
    H, W = output.shape[-2:]
    if idx is not None and _is_identity((sy, sx), (h, w), H, W):
        return idx, score
    if (h, w) == (len(range(*sy.indices(H))), len(range(*sx.indices(W)))):
        return semantic_argmax_score(output[:, :, sy, sx])
    return crop_resize_argmax_score(output, (sy, sx), h, w)


class SemanticPostprocessing(DensePostprocessingBase):
    def _postprocess_training(self, data, batch):
        output, side_outputs = data
        if isinstance(output, DEFERRED_TYPES):
            raise ValueError('training takes a configuration without '
                             'deferred upsampling')
        return {'semantic_output': output,
                'semantic_side_outputs': side_outputs}

    def _postprocess_inference(self, data, batch, keys=None, extra=()):
        output, side_outputs = data
        named = set(extra) | set(keys or ())
        fullres = has_valid_region(batch)
        want_maps = fullres and any(wants(keys, k) for k in _FULLRES_KEYS)
        want_dense = fullres and bool(named & set(_DENSE_FULLRES_KEYS))
        deferred = identity = None
        if fullres:
            crop_slices, shape = self._fullres_args(batch, 'semantic')
        if isinstance(output, DEFERRED_TYPES):
            deferred = output
            idx, score = _FINISH[type(deferred)](deferred)
            H, W = (n * _SCALE[type(deferred)] for n in deferred.x.shape[-2:])
            identity = fullres and _is_identity(crop_slices, shape, H, W)
            if (named & {'semantic_output', SOFTMAX_KEY} or want_dense
                    or (want_maps and not identity)):
                output = apply_deferred_upsampling_exact(deferred)
        else:
            idx, score = semantic_argmax_score(output)
        r_dict = {'semantic_output': output,
                  'semantic_side_outputs': side_outputs,
                  'semantic_segmentation_score': score,
                  'semantic_segmentation_idx': idx}
        if SOFTMAX_KEY in named:
            r_dict[SOFTMAX_KEY] = torch.softmax(output, dim=1)
        if want_maps:
            r_dict[_FULLRES_KEYS[0]], r_dict[_FULLRES_KEYS[1]] = (
                (idx, score) if identity
                else fullres_idx_score(output, batch, idx, score))
        if want_dense:
            if identity:
                output_fullres = output
            else:
                cropped = output[:, :, crop_slices[0], crop_slices[1]]
                output_fullres = (
                    cropped if deferred is None
                    and tuple(cropped.shape[-2:]) == tuple(shape)
                    else resize_bilinear(cropped.float(), *shape))
            r_dict[_DENSE_FULLRES_KEYS[0]] = output_fullres
            r_dict[_DENSE_FULLRES_KEYS[1]] = torch.softmax(output_fullres,
                                                           dim=1)
        return r_dict

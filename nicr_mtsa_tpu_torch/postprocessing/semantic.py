"""Semantic postprocessing (counterpart of
nicr_mtsa_tpu/postprocessing/semantic.py). Training passes the outputs
on (a deferred head raises: training applies its upsamplings).
Inference: first-argmax idx and
max-softmax score from the fused 2x finisher for a head that deferred
its last upsampling, from the fused 4x finisher for a head that
deferred both (learned-3x3-zeropad or bilinear), else from the logits
by the score/argmax kernel; with a valid region in the
batch, the full-resolution idx/score come from the crop + resize +
reduce kernel without building the full-resolution logits. Keys follow
the JAX package; the dense softmax and full-resolution logits keys are
not computed (nothing on the ported paths reads them)."""
from ..data.fullres import (get_fullres_key,
                            get_valid_region_slices_and_fullres_shape,
                            has_valid_region)
from ..models.upsampling import (DEFERRED_TYPES, DeferredBilinear2,
                                DeferredUpsampling, DeferredUpsampling2)
from ..ops.cuda.finisher2x import finish_deferred_semantic
from ..ops.cuda.finisher4x import (finish_deferred_bilinear2,
                                   finish_deferred_semantic2)
from ..ops.cuda.resize_reduce import crop_resize_argmax_score
from ..ops.cuda.semantic_reduce import semantic_argmax_score
from .base import DensePostprocessingBase, wants

_FULLRES_KEYS = (get_fullres_key('semantic_segmentation_idx'),
                 get_fullres_key('semantic_segmentation_score'))


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
    if idx is not None and sy.indices(H) == (0, H, 1) \
            and sx.indices(W) == (0, W, 1) and (h, w) == (H, W):
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

    def _postprocess_inference(self, data, batch, keys=None):
        output, side_outputs = data
        want_fullres = (has_valid_region(batch)
                        and any(wants(keys, k) for k in _FULLRES_KEYS))
        if isinstance(output, DEFERRED_TYPES):
            if want_fullres:
                raise NotImplementedError(
                    'full-resolution keys of a deferred semantic head are '
                    'not ported yet')
            finish = {DeferredUpsampling: finish_deferred_semantic,
                      DeferredUpsampling2: finish_deferred_semantic2,
                      DeferredBilinear2: finish_deferred_bilinear2}
            idx, score = finish[type(output)](output)
        else:
            idx, score = semantic_argmax_score(output)
        r_dict = {'semantic_output': output,
                  'semantic_side_outputs': side_outputs,
                  'semantic_segmentation_score': score,
                  'semantic_segmentation_idx': idx}
        if not want_fullres:
            return r_dict

        idx_fr, score_fr = fullres_idx_score(output, batch, idx, score)
        r_dict[_FULLRES_KEYS[0]] = idx_fr
        r_dict[_FULLRES_KEYS[1]] = score_fr
        return r_dict

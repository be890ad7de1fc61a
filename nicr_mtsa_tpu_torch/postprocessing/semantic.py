"""Semantic postprocessing, inference branch of the serving path
(counterpart of nicr_mtsa_tpu/postprocessing/semantic.py): idx and
score from the fused 4x finisher for a deferred head, else from the
dense logits. Keys follow the JAX package. Full-resolution keys and
the dense softmax are not computed: the serving dict reads neither."""
from ..models.upsampling import DeferredUpsampling2
from ..ops.cuda.finisher4x import finish_deferred_semantic2
from ..ops.reduce import semantic_score_idx
from .base import PostprocessingBase


class SemanticPostprocessing(PostprocessingBase):
    def _postprocess_inference(self, data, batch):
        output, side_outputs = data
        if isinstance(output, DeferredUpsampling2):
            idx, score = finish_deferred_semantic2(output)
        else:
            idx, score = semantic_score_idx(output, dim=1)
        return {'semantic_output': output,
                'semantic_side_outputs': side_outputs,
                'semantic_segmentation_score': score,
                'semantic_segmentation_idx': idx}

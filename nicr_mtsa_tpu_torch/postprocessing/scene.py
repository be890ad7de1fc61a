"""Scene postprocessing (counterpart of
nicr_mtsa_tpu/postprocessing/scene.py)."""
import torch

from ..ops.reduce import first_argmax
from .base import PostprocessingBase


class ScenePostprocessing(PostprocessingBase):
    def _postprocess_training(self, data, batch):
        output, _ = data
        return {'scene_output': output}

    def _postprocess_inference(self, data, batch, keys=None):
        output, _ = data
        pred = torch.softmax(output.float(), dim=-1)
        return {'scene_class_score': pred.amax(dim=-1),
                'scene_class_idx': first_argmax(pred, -1).to(torch.int32),
                'scene_output': output}

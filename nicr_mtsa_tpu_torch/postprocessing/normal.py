"""Surface-normal postprocessing (counterpart of
nicr_mtsa_tpu/postprocessing/normal.py). Training passes the outputs
on; inference adds `normal_output_fullres`: the prediction cropped to
the valid region and nearest-resized to the full resolution of the
batch's `normal_fullres` (else of `rgb_fullres` or `depth_fullres`),
where the batch records a Resize and the caller reads the key."""
from .base import DensePostprocessingBase


class NormalPostprocessing(DensePostprocessingBase):
    def _postprocess_training(self, data, batch):
        output, side_outputs = data
        return {'normal_output': output,
                'normal_side_outputs': side_outputs}

    def _postprocess_inference(self, data, batch, keys=None):
        r_dict = self._postprocess_training(data, batch)
        self._add_fullres(r_dict, batch, 'normal_output', keys, 'normal')
        return r_dict

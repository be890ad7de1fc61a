"""Postprocessing base: train/inference dispatch (counterpart of
nicr_mtsa_tpu/postprocessing/base.py). This slice ports the inference
branches of the serving path only."""


class PostprocessingBase:
    def postprocess(self, data, batch=None, is_training: bool = False):
        if is_training:
            raise NotImplementedError(
                'training postprocessing is not ported yet')
        return self._postprocess_inference(data, batch or {})

    def _postprocess_inference(self, data, batch):
        raise NotImplementedError

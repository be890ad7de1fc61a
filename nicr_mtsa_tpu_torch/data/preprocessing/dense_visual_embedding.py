"""Dense-visual-embedding targets as a LUT and an index image (own copy
of nicr_mtsa_tpu/data/preprocessing/dense_visual_embedding.py). Each
panoptic segment of a sample carries one embedding
(`panoptic_embedding`, a dict keyed by panoptic id); the sample gets
the (n_segments, D) f32 LUT of those embeddings, each moved away from
the image's embedding by `diff_factor` times it and L2-normalised, in
the dict's order, and the int32 index image of each pixel's one-based
LUT row (0: no segment). A sample without `image_embedding` or
`panoptic_embedding` passes through untouched."""
from typing import Any, Dict, Tuple

import numpy as np

from .base import PreprocessingBase
from .utils import _keys_available


def _localize(embedding: np.ndarray, image_embedding: np.ndarray,
              diff_factor: float) -> np.ndarray:
    shifted = embedding - diff_factor * image_embedding
    return shifted / np.linalg.norm(shifted, axis=-1, keepdims=True)


def _index_image(panoptic: np.ndarray, segment_ids: np.ndarray
                 ) -> np.ndarray:
    """int32 image of one-based positions in `segment_ids` (0 where the
    pixel's id is not listed), by one sorted search over the pixels."""
    if not len(segment_ids):
        return np.zeros(panoptic.shape, dtype=np.int32)
    order = np.argsort(segment_ids)
    table = segment_ids[order]
    pixels = panoptic.astype(np.int64).ravel()
    slot = np.clip(np.searchsorted(table, pixels), 0, len(table) - 1)
    dense = np.where(table[slot] == pixels, order[slot] + 1, 0)
    return dense.astype(np.int32).reshape(panoptic.shape)


class DenseVisualEmbeddingTargetGenerator(PreprocessingBase):
    """`dense_visual_embedding_lut` and `dense_visual_embedding_indices`
    of a sample's segment embeddings."""

    def __init__(self, diff_factor: float = 0.65,
                 multiscale_processing: bool = True) -> None:
        super().__init__(multiscale_processing=multiscale_processing)
        self.diff_factor = diff_factor

    def _preprocess(self, sample: dict, **kwargs
                    ) -> Tuple[dict, Dict[str, Any]]:
        if not _keys_available(sample, ('image_embedding',
                                        'panoptic_embedding')):
            return sample, {}
        localized = {
            seg_id: _localize(vec, sample['image_embedding'],
                              self.diff_factor)
            for seg_id, vec in sample['panoptic_embedding'].items()}
        ids = np.fromiter((int(i) for i in localized), dtype=np.int64,
                          count=len(localized))
        sample['dense_visual_embedding_lut'] = np.array(
            list(localized.values()), dtype=np.float32)
        sample['dense_visual_embedding_indices'] = _index_image(
            sample['panoptic'], ids)
        return sample, {}

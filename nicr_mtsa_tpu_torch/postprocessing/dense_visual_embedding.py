"""Dense-visual-embedding postprocessing, inference branch (counterpart
of nicr_mtsa_tpu/postprocessing/dense_visual_embedding.py): semantic
retrieval by the cosine similarity of each pixel's embedding with the
class embeddings of a text table and of a visual-mean table, (C, D)
each.

The logits are `(x @ table^T) / max(||x||, 1e-12)`: the per-pixel
normalisation is applied to the (C-channel) logits, not to the
(D-channel) map, as in the JAX package. They are computed image by
image in f32, so the map's f32 copy is one image's (at 480 x 640 x 512,
0.63 GB), and laid out (B, C, H, W) channels-last, a pixel's classes
contiguous. The full-resolution idx/score come from the crop + resize +
reduce kernel, as the semantic ones do. Only the keys a caller reads
are computed: the working-resolution `<prefix>_output` (the logits),
`_score` and `_idx`, and the full-resolution `_idx_fullres` and
`_score_fullres`; the dense softmax and full-resolution logits keys of
the JAX package are not (nothing reads them)."""
import numpy as np
import torch

from ..data.fullres import get_fullres_key, has_valid_region
from ..ops.cuda.semantic_reduce import semantic_argmax_score
from .base import DensePostprocessingBase, wants
from .semantic import fullres_idx_score

TEXT_PREFIX = 'dense_visual_embedding_text_based_semantic'
VISUAL_MEAN_PREFIX = 'dense_visual_embedding_visual_mean_based_semantic'


class DenseVisualEmbeddingPostprocessing(DensePostprocessingBase):
    def __init__(self, with_text_embeddings_per_class: bool = False,
                 text_embeddings_per_class=None,
                 with_mean_visual_embedding_per_class: bool = False,
                 mean_visual_embedding_per_class=None):
        self._tables = {}                 # prefix -> (C, D) f32, host
        for prefix, on, table in (
                (TEXT_PREFIX, with_text_embeddings_per_class,
                 text_embeddings_per_class),
                (VISUAL_MEAN_PREFIX, with_mean_visual_embedding_per_class,
                 mean_visual_embedding_per_class)):
            if not on:
                continue
            if table is None:
                raise ValueError(f'{prefix}: the class embedding table is '
                                 f'missing')
            self._tables[prefix] = torch.as_tensor(
                np.asarray(table, np.float32))
        self._on_device = {}              # (prefix, device) -> table

    def _table(self, prefix, device):
        """The class table on `device`, copied once (outside inference
        mode: a step's inference tensors must not be cached)."""
        key = (prefix, str(device))
        if key not in self._on_device:
            with torch.inference_mode(False):
                self._on_device[key] = self._tables[prefix].to(device)
        return self._on_device[key]

    def _postprocess_training(self, data, batch):
        output, side_outputs = data
        return {'dense_visual_embedding_output': output,
                'dense_visual_embedding_side_outputs': side_outputs}

    def retrieval_logits(self, output, prefixes):
        """{prefix: (B, C, H, W) f32 logits, channels-last} of the NCHW
        embedding map `output` against each prefix's table."""
        if not prefixes:
            return {}
        B, D, H, W = output.shape
        tables = {p: self._table(p, output.device) for p in prefixes}
        logits = {p: torch.empty((B, H, W, t.shape[0]), dtype=torch.float32,
                                 device=output.device)
                  for p, t in tables.items()}
        for b in range(B):
            x = output[b].permute(1, 2, 0).reshape(H * W, D).float()
            inv_norm = 1.0 / torch.clamp(
                torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)
            for p, t in tables.items():
                out = logits[p][b].view(H * W, t.shape[0])
                torch.mm(x, t.t(), out=out)
                out.mul_(inv_norm)
        return {p: v.permute(0, 3, 1, 2) for p, v in logits.items()}

    def _postprocess_inference(self, data, batch, keys=None):
        output, side_outputs = data
        r_dict = {'dense_visual_embedding_output': output,
                  'dense_visual_embedding_side_outputs': side_outputs}
        fullres = has_valid_region(batch)

        def read(prefix, suffixes, at_fullres=False):
            return any(wants(keys, get_fullres_key(prefix + s) if at_fullres
                             else prefix + s) for s in suffixes)
        work = [p for p in self._tables if read(p, ('_idx', '_score'))]
        full = [p for p in self._tables
                if fullres and read(p, ('_idx', '_score'), True)]
        needed = [p for p in self._tables
                  if p in work or p in full or read(p, ('_output',))]
        for prefix, x in self.retrieval_logits(output, needed).items():
            out = {f'{prefix}_output': x}
            if prefix in work:
                out[f'{prefix}_idx'], out[f'{prefix}_score'] = \
                    semantic_argmax_score(x)
            if prefix in full:
                (out[get_fullres_key(f'{prefix}_idx')],
                 out[get_fullres_key(f'{prefix}_score')]) = \
                    fullres_idx_score(x, batch)
            r_dict.update({k: v for k, v in out.items() if wants(keys, k)})
        return r_dict

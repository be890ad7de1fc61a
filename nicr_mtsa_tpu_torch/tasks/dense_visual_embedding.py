"""Dense-visual-embedding task helper (counterpart of
nicr_mtsa_tpu/tasks/dense_visual_embedding.py).

The targets are a per-image LUT of segment embeddings, padded to
(B, L+1, D) with row 0 the void row, and an index map (B, H, W) of
each pixel's LUT row (0: void). The loss, per valid pixel, is
`1 - cos(p, lut[idx])` (or the MSE / L1 over D), summed and divided by
the number of valid pixels. The cosine goes through the score matrix
`p @ lut^T` (an image's (P, L+1), in f32): the numerator is the score
at the pixel's index and the target norm the LUT row's norm there, so
the dense (B, P, D) target never exists (5.0 GB in f32 at B=8, 480 x
640, D=512).

The metric states are two confusion matrices, of the text-based and of
the visual-mean-based retrieval at full resolution against the
full-resolution semantic ground truth, void left out (the JAX package
counts void into the (0, 0) cell and subtracts it again); their epoch
results are the two retrieval mIoUs. The fused step updates them
through `update_metric_states`, the eager `validation_step` through
the same code into the helper's own states, with the losses of
`compute_losses`; with `store_examples` the eager step of batch 0 also
renders the text-based retrieval of its first image (`examples_cmap`:
the semantic palette)."""
from typing import List

import numpy as np
import torch

from ..data.fullres import get_fullres_key
from ..losses import L1Loss, MSELoss
from ..metrics import MeanIntersectionOverUnion, confusion_matrix
from ..metrics.base import to_numpy
from ..models.upsampling import resize_nearest
from ..postprocessing.dense_visual_embedding import (TEXT_PREFIX,
                                                     VISUAL_MEAN_PREFIX)
from ..visualization import visualize_semantic_pil
from .base import (TaskHelperBase, append_detached_losses_to_logs,
                   append_profile_to_logs, epoch_end, to_numpy as np_of)

KNOWN_DENSE_VISUAL_EMBEDDING_LOSS_FUNCTIONS = ('cos_emb', 'mse', 'l1')
# metric state -> (the full-resolution retrieval idx it counts, log key)
_STATES = {
    'text_cm': (get_fullres_key(f'{TEXT_PREFIX}_idx'),
                'dense_visual_embedding_text_miou'),
    'visual_mean_cm': (get_fullres_key(f'{VISUAL_MEAN_PREFIX}_idx'),
                       'dense_visual_embedding_visual_mean_miou')}


def pad_embedding_luts(luts: List[np.ndarray], embedding_dim: int):
    """Ragged per-image LUTs (L_b, D) -> (B, L_max+1, D) f32; row 0 is
    the void row, so the index map gathers directly."""
    max_len = max((lut.shape[0] if lut.ndim == 2 else 0) for lut in luts)
    padded = np.zeros((len(luts), max_len + 1, embedding_dim), np.float32)
    for b, lut in enumerate(luts):
        if lut.ndim == 2 and lut.shape[0]:
            padded[b, 1:1 + lut.shape[0]] = lut
    return padded


class DenseVisualEmbeddingTaskHelper(TaskHelperBase):
    prediction_keys = ('dense_visual_embedding_output',
                       'dense_visual_embedding_side_outputs',
                       *(key for key, _ in _STATES.values()))

    def __init__(self, n_classes: int, loss_name: str = 'cos_emb',
                 examples_cmap=None, store_examples: bool = False):
        self._loss_name = loss_name.lower()
        if self._loss_name not in KNOWN_DENSE_VISUAL_EMBEDDING_LOSS_FUNCTIONS:
            raise ValueError(f'unknown loss {loss_name!r}')
        self._n_classes = n_classes
        self._examples = {}
        self._examples_cmap = examples_cmap
        self._store_examples = store_examples
        # the working-resolution retrieval its example image shows
        self.validation_keys = (f'{TEXT_PREFIX}_idx',) if store_examples \
            else ()
        # the cosine goes through the score matrix (`_pixel_losses`)
        self._loss = (None if self._loss_name == 'cos_emb' else
                      {'mse': MSELoss, 'l1': L1Loss}[self._loss_name](
                          reduction='none'))
        self._metrics = {k: MeanIntersectionOverUnion(n_classes)
                         for k in _STATES}

    def _pixel_losses(self, p, lut, idx):
        """(P,) f32 losses of one image's predictions p (P, D) against
        its LUT (L+1, D) f32 at the index of each pixel, idx (P,)."""
        x = p.float()
        if self._loss_name == 'cos_emb':
            num = torch.gather(x @ lut.t(), 1, idx[:, None])[:, 0]
            t_norm = torch.linalg.vector_norm(lut, dim=1)[idx]
            x_norm = torch.linalg.vector_norm(x, dim=1)
            return 1.0 - num / torch.clamp(x_norm * t_norm, min=1e-8)
        (per_elem, _), = self._loss([x], [lut[idx]])
        return per_elem.mean(dim=1)

    def compute_losses(self, batch, predictions_post) -> dict:
        preds, keys, targets = self.collect_predictions_for_loss(
            batch, predictions_post, 'dense_visual_embedding_output',
            'dense_visual_embedding_side_outputs')
        D = preds[0].shape[1]
        lut = batch['dense_visual_embedding_lut']
        if isinstance(lut, (list, tuple)):           # ragged LUTs
            lut = torch.from_numpy(pad_embedding_luts(
                [t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                 else np.asarray(t) for t in lut], D))
        lut = lut.to(preds[0].device, torch.float32)
        main_idx = batch['dense_visual_embedding_indices']
        outs = []
        for pred, t in zip(preds, targets):
            B, _, h, w = pred.shape
            # a scale without its own index map takes the main one
            idx = t.get('dense_visual_embedding_indices', main_idx)
            if tuple(idx.shape[1:]) != (h, w):
                idx = resize_nearest(idx, h, w)
            idx = idx.reshape(B, h * w).long()
            loss = sum(torch.where(idx[b] != 0, self._pixel_losses(
                pred[b].permute(1, 2, 0).reshape(h * w, D), lut[b], idx[b]),
                0.0).sum() for b in range(B))
            outs.append((loss, torch.clamp((idx != 0).sum(dtype=torch.int32),
                                           min=1)))
        d = {f'dense_visual_embedding_loss_{k}': loss / n
             for k, (loss, n) in zip(keys, outs)}
        d[self.mark_as_total('dense_visual_embedding')] = \
            self.accumulate_losses([loss for loss, _ in outs],
                                   [n for _, n in outs])
        return d

    def empty_metric_states(self, device=None):
        return {k: m.empty_state(device) for k, m in self._metrics.items()}

    def update_metric_states(self, state, batch, predictions_post):
        """Each retrieval's full-resolution idx against the
        full-resolution semantic ground truth (void left out, labels
        shifted by -1); a retrieval the predictions lack leaves its
        matrix as it is."""
        target = self.get_fullres(batch, 'semantic')
        if state is None:
            state = self.empty_metric_states(target.device)
        t = torch.where(target != 0, target.long() - 1, -1)
        new = dict(state)
        for k, (key, _) in _STATES.items():
            if key in predictions_post:
                new[k] = state[k] + confusion_matrix(
                    predictions_post[key], t, self._n_classes)
        return new

    def load_metric_states(self, state):
        for k, m in self._metrics.items():
            m.state = state[k]

    @append_profile_to_logs('dense_visual_embedding_step_time')
    @append_detached_losses_to_logs
    def training_step(self, batch, batch_idx, predictions_post):
        return self.compute_losses(batch, predictions_post), {}

    @append_profile_to_logs('dense_visual_embedding_step_time')
    @append_detached_losses_to_logs
    def validation_step(self, batch, batch_idx, predictions_post):
        losses = self.compute_losses(batch, predictions_post)
        self.update_eagerly(batch, predictions_post)
        key = f'{TEXT_PREFIX}_idx'
        if self._store_examples and batch_idx == 0 \
                and key in predictions_post:
            self._examples['dve_text_semantic_example_batch_0_0'] = \
                visualize_semantic_pil(np_of(predictions_post[key][0]),
                                       colors=self._examples_cmap)
        return losses, {}

    @epoch_end('dense_visual_embedding_epoch_end_time')
    def validation_epoch_end(self):
        """The mIoU of each retrieval whose matrix holds counts."""
        logs = {}
        for k, (_, log_key) in _STATES.items():
            m = self._metrics[k]
            if int(np.asarray(to_numpy(m.state)).sum()):
                logs[log_key] = m.compute()
            m.reset()
        return {}, self._examples, logs

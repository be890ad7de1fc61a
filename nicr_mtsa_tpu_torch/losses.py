"""Losses of the eval step and, under autograd, of the training step
(counterpart of nicr_mtsa_tpu/losses/). A loss maps per-scale (input,
target) pairs to (loss_sum, n_elements) tuples; n_elements stays a
device scalar (with reduction='none': the per-element loss and the
input's element count). Dense inputs are NCHW, maps (B, H, W)."""
import torch

from .utils.dtypes import upcast


class LossBase:
    def _compute_loss(self, input_, target):
        raise NotImplementedError

    def __call__(self, input_tensors, target_tensors):
        return tuple(self._compute_loss(i, t)
                     for i, t in zip(input_tensors, target_tensors))


class CrossEntropyLossSemantic(LossBase):
    """Semantic cross-entropy over the class axis 1: targets carry void
    as 0 and are shifted by -1; void pixels are not counted. Optional
    per-class weights and label smoothing as in the JAX package."""

    def __init__(self, weights=None, label_smoothing: float = 0.0):
        self._weights = (None if weights is None
                         else torch.as_tensor(weights, dtype=torch.float32))
        self._label_smoothing = float(label_smoothing)

    def _compute_loss(self, input_, target):
        n_classes = input_.shape[1]
        t = target.long() - 1
        valid = t >= 0
        tclip = t.clamp(0, n_classes - 1)
        logp = torch.log_softmax(upcast(input_), dim=1)
        nll = -torch.gather(logp, 1, tclip[:, None])[:, 0]
        if self._label_smoothing > 0.0:
            ls = self._label_smoothing
            nll = (1.0 - ls) * nll + ls * -logp.mean(dim=1)
        if self._weights is not None:
            nll = nll * self._weights.to(nll.device)[tclip]
        loss = torch.where(valid, nll, 0.0).sum()
        return loss, valid.sum(dtype=torch.int32)


def _reduce(loss, reduction: str):
    """'sum': the mean over the channel axis of (B, C, H, W) or (N, C),
    then the sum, n = the number of pixels; 'none': the per-element
    loss, n = its element count (the callers of 'none' count their own
    masked elements)."""
    if reduction == 'none':
        return loss, loss.numel()
    if loss.dim() in (2, 4):
        loss = loss.mean(dim=1)
    return loss.sum(), torch.tensor(loss.numel(), dtype=torch.int32,
                                    device=loss.device)


class _ElementwiseLoss(LossBase):
    def __init__(self, reduction: str = 'sum'):
        if reduction not in ('sum', 'none'):
            raise ValueError(f'unknown reduction {reduction!r}')
        self._reduction = reduction


class L1Loss(_ElementwiseLoss):
    def _compute_loss(self, input_, target):
        return _reduce(torch.abs(upcast(input_) - upcast(target)),
                       self._reduction)


class MSELoss(_ElementwiseLoss):
    def _compute_loss(self, input_, target):
        diff = upcast(input_) - upcast(target)
        return _reduce(diff * diff, self._reduction)


class CosineEmbeddingLoss(_ElementwiseLoss):
    """1 - cos(input, target) over the channel axis 1, the product of
    the norms clamped at 1e-8 (similar pairs, the only mode the JAX
    package's callers use). The loss has no channel axis, so 'sum' sums
    it as it is."""

    def _compute_loss(self, input_, target):
        x, y = upcast(input_), upcast(target)
        cos = (x * y).sum(dim=1) / torch.clamp(
            torch.linalg.vector_norm(x, dim=1)
            * torch.linalg.vector_norm(y, dim=1), min=1e-8)
        loss = 1.0 - cos
        if self._reduction == 'none':
            return loss, input_.numel()
        return _reduce(loss.reshape(-1), 'sum')


def von_mises_biternion(input_, target, kappa: float = 1.0):
    """Per-pixel von Mises loss 1 - exp(kappa * (cos(delta) - 1)) of
    biternion maps (B, 2, H, W) -> (B, H, W)."""
    cos_delta = (upcast(input_) * upcast(target)).sum(dim=1)
    return 1.0 - torch.exp(kappa * (cos_delta - 1.0))


__all__ = ['LossBase', 'CrossEntropyLossSemantic', 'CosineEmbeddingLoss',
           'L1Loss', 'MSELoss', 'von_mises_biternion']

"""First-index argmax and the max-softmax score over a class axis.

torch documents first-index ties for argmax/argmin, but the exactness
of every selection in the port rests on it, so the port states it
explicitly: the index is the smallest one attaining the extremum."""
import torch


def _first_index_of(x, m, dim: int):
    """Smallest index along `dim` where x equals m (keepdim shape)."""
    n = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = n
    iota = torch.arange(n, device=x.device).view(shape)
    return torch.where(x == m, iota, n).amin(dim=dim)


def first_argmax(x, dim: int):
    """Smallest index attaining the maximum along `dim`."""
    return _first_index_of(x, x.amax(dim=dim, keepdim=True), dim)


def first_argmin(x, dim: int):
    """Smallest index attaining the minimum along `dim`."""
    return _first_index_of(x, x.amin(dim=dim, keepdim=True), dim)


def semantic_score_idx(logits, dim: int = 1):
    """(idx int32, score f32) of class logits: the first argmax and the
    max-softmax score 1 / sum_c exp(l_c - max)."""
    lf = logits.float()
    m = lf.amax(dim=dim, keepdim=True)
    s = torch.exp(lf - m).sum(dim=dim)
    return first_argmax(lf, dim).to(torch.int32), 1.0 / s

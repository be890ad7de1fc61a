"""Where the JAX package computes in f32 whatever its compute dtype
(normalisation statistics, softmax, losses), the port computes in f32,
or in f64 where the tensor is f64 already: a float64 run of the model
then holds no f32 step (the tests take one as a reference)."""
import torch


def upcast(t: torch.Tensor) -> torch.Tensor:
    """t as float32, or as it is where it is float64."""
    return t if t.dtype == torch.float64 else t.float()

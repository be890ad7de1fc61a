"""Postprocessing operators of the serving path. The hand-written CUDA
kernels and their plain versions live in `ops/cuda/`; importing them
builds nothing (kernels are compiled at first launch)."""

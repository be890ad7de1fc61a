"""Orientation (biternion <-> angle) math (counterpart of
nicr_mtsa_tpu/utils/_orientation.py).

A biternion is a (cos, sin) pair in the last dimension;
`biternion2rad` computes atan2(sin, cos) (range (-pi, pi]); degrees
wrap to [0, 360). Two flavours: the plain names on torch tensors (on
any device) and `np_*` for host-side numpy preprocessing.
`unit_length` is the task heads' (models/decoders/heads.py); it
normalises along `dim`, the channels (1) unless the caller names
another."""

import numpy as np
import torch

from ..models.decoders.heads import unit_length


# --- torch versions ----------------------------------------------------------

def rad2deg(rad):
    return torch.rad2deg(rad) % 360


def deg2rad(deg):
    return torch.deg2rad(deg)


def rad2biternion(rad):
    """angle (...,) -> biternion (..., 2) as (cos, sin)."""
    return torch.stack([torch.cos(rad), torch.sin(rad)], dim=-1)


def biternion2rad(biternion):
    """biternion (..., 2) as (cos, sin) -> angle (...,) in (-pi, pi]."""
    return torch.atan2(biternion[..., 1], biternion[..., 0])


def deg2biternion(deg):
    return rad2biternion(deg2rad(deg))


def biternion2deg(biternion):
    return rad2deg(biternion2rad(biternion))


# --- numpy versions (host preprocessing) ------------------------------------

def np_rad2deg(rad):
    return np.rad2deg(rad) % 360


def np_rad2biternion(rad):
    """array([cos, sin]) as float32."""
    return np.array([np.cos(rad), np.sin(rad)], dtype='float32')


def np_biternion2rad(biternion):
    biternion = np.asarray(biternion)
    return np.arctan2(biternion[..., 1], biternion[..., 0])


__all__ = ['rad2deg', 'deg2rad', 'rad2biternion', 'biternion2rad',
           'deg2biternion', 'biternion2deg', 'unit_length', 'np_rad2deg',
           'np_rad2biternion', 'np_biternion2rad']

"""Metrics with device-resident states (counterpart of
nicr_mtsa_tpu/metrics/): mIoU and PQ with the orientation MAE."""
from .base import MetricBase
from .mae import abs_angle_error_rad
from .miou import MeanIntersectionOverUnion, confusion_matrix
from .pq import (PanopticQuality, PanopticQualityWithOrientationMAE,
                 pq_compare)

__all__ = ['MetricBase', 'abs_angle_error_rad', 'MeanIntersectionOverUnion',
           'confusion_matrix', 'PanopticQuality',
           'PanopticQualityWithOrientationMAE', 'pq_compare']

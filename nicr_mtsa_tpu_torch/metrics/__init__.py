"""Metrics with device-resident states (counterpart of
nicr_mtsa_tpu/metrics/): mIoU, PQ with the orientation MAE, the mean
absolute angular error and the surface normals' per-pixel RMSE."""
from .base import MetricBase
from .mae import MeanAbsoluteAngularError, abs_angle_error_rad
from .miou import MeanIntersectionOverUnion, confusion_matrix
from .pq import (PanopticQuality, PanopticQualityWithOrientationMAE,
                 pq_compare)
from .rmse import RootMeanSquaredError

__all__ = ['MetricBase', 'MeanAbsoluteAngularError',
           'abs_angle_error_rad', 'MeanIntersectionOverUnion',
           'confusion_matrix', 'PanopticQuality',
           'PanopticQualityWithOrientationMAE', 'RootMeanSquaredError',
           'pq_compare']

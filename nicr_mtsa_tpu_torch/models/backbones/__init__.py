"""Backbones of the port: ResNet-18/34 with basicblock or
nonbottleneck1d blocks (the Swin family comes with a later slice)."""
from .base import Backbone
from .resnet import ResNetBackbone, get_resnet_backbone

__all__ = ['Backbone', 'ResNetBackbone', 'get_resnet_backbone']

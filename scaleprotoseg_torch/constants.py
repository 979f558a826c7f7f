"""Normalization constants (ImageNet statistics, used by every dataset)."""

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

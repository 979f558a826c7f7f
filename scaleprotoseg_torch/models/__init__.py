"""DeepLabV2 backbone, PPNet head and the model factory."""

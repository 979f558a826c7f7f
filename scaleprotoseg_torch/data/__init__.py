"""Training data: the augmentation pipeline and the prefetching loader."""

"""The part-based interpretability metrics: consistency and stability."""

"""Training losses of the prototype phase."""

"""Prototype-phase training: optimizer, steps, metrics, phase runner."""

"""Prototype push: projection of the bank onto training pixels."""

"""Utilities: devices, simple gradient descent, LHS sampling, padding."""

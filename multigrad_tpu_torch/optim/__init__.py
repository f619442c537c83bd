"""Optimizers (Adam, L-BFGS-B) and the bounds bijections."""

"""Evaluation: the depth error metrics online validation needs."""

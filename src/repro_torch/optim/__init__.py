"""Optimizers and learning-rate schedules (``repro/optim``)."""

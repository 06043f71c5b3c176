"""Optimizers and weight quantization (port of ``repro/optim``)."""

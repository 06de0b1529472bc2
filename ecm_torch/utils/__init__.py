"""Utilities of the port (``ecm_tpu.utils``): tracing, timing and the
analytic FLOP and byte models of the flagship forward."""

"""Measurement helpers (counterpart of ``theanompi_tpu.utils``)."""

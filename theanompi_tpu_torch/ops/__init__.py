"""Layers and kernels of the port (counterpart of ``theanompi_tpu.ops``)."""

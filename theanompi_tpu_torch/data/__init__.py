"""Data providers and the prefetching loader (counterpart of
``theanompi_tpu.data``)."""

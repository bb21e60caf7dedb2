"""Models of the port (counterpart of ``theanompi_tpu.models``)."""

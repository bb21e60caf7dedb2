"""Runtime of the port: config, process group, recorder (counterpart of
``theanompi_tpu.runtime``)."""

"""Data-parallel training: exchange, bucketing, workers, rules
(counterpart of ``theanompi_tpu.parallel``)."""

"""Sharded execution and the exchange (port of ``cylon_tpu/parallel``)."""

"""Metrics of the port: the influx line encoder (``encoder``)."""

"""Measuring tools of the port (the counterparts of ``tools/``)."""

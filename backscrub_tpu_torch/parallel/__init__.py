"""Serving many camera streams on one card (``parallel/streams.py``)."""

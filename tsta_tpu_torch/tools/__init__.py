"""Measurement scripts for the port, run on the card (``python -m``)."""

"""Measurement tools of the port, run as modules on the card."""

"""Probes of the port on the card: measurements beside the main paths."""

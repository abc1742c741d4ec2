"""Measurement scripts of the port that are not part of any entry point."""

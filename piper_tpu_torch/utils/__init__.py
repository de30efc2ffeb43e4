"""Helpers shared by the port's entry points."""

"""Encoders."""

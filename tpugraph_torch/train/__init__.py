"""Losses, evaluation, the serving-side loop pieces and the driver."""

"""Losses, the OT head, negatives, optimizer, metrics, evaluation, the
training loops and the driver."""

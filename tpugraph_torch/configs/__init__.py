"""Run configurations."""

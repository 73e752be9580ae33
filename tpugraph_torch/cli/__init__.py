"""The trainer's command line."""

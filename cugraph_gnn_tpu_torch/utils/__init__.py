"""Process-group start-up and shutdown."""

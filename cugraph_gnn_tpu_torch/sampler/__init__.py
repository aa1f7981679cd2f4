"""Multi-hop neighbor sampling."""

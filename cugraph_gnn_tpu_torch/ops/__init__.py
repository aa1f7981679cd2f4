"""Graph ops: row gather, neighbor sampling, fixed-fanout aggregation."""

"""The process-group mesh that row-sharded arrays live on."""

"""Row partitioning and the distributed gather and scatter over it."""

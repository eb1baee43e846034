"""The synthetic token stream (``pipeline``)."""

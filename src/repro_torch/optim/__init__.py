"""AdamW with 8-bit moments (``adamw``)."""

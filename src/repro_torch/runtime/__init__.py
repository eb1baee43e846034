"""The train step, its gradient sync and the loop driver (``trainer``,
``overlap``)."""

"""The port's language models (``layers``, ``transformer``)."""

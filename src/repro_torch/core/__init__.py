"""Hardware description, dataflow taxonomy and the GeMM mapper."""

"""Training-side state of the port: so far the restore of a generator's
parameters for evaluation (``checkpoint``)."""

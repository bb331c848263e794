"""Distribution of the port (reference: ``repro/parallel/``)."""

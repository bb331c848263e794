"""Model functions of the port (reference: ``repro/models/``)."""

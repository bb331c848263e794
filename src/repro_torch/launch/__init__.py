"""Entry points of the port (reference: ``repro/launch/``)."""

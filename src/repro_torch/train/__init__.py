"""Step builders of the port (reference: ``repro/train/``)."""

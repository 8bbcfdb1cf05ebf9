"""Model code (port of ``repro/models/``)."""

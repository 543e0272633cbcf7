"""MiTA core (port of ``repro.core``)."""

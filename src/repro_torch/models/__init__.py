"""Models (port of ``repro.models``): the dense MiTA LM."""

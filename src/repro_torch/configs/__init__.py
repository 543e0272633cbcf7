"""Architecture configs (port of ``repro.configs``)."""

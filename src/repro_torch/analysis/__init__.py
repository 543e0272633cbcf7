"""Roofline terms and the tools that read the dry run's records (port of
``repro.analysis``)."""
